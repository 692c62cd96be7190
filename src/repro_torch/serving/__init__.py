"""Continuous-batching serving on the paged int8-KV block pool: the
host-side pool, prefix cache and scheduler (numpy, copied from the JAX
package), on-device sampling, and the engine."""
