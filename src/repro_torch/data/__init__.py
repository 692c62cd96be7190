from repro_torch.data.pipeline import (ShardedLoader,  # noqa: F401
                                      SyntheticLMStream,
                                      make_calibration_batch)

__all__ = ["SyntheticLMStream", "ShardedLoader", "make_calibration_batch"]
