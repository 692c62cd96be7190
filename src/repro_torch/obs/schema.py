"""Golden report schema (DESIGN §14): the committed contract for every
metric the serving engine reports.

``GOLDEN_SCHEMA`` is the full-featured engine's registry (speculation ON,
prefix cache ON) projected down to the stable identity fields — kind,
python type, unit, optionality, aliasing.  Help strings are deliberately
NOT part of the contract (they may be reworded freely; the golden test
only asserts they are non-empty).  Regenerate after an intentional
schema change by pasting ``schema_of(engine.metrics)`` — the golden test
(``tests/test_obs.py``) and the CI schema diff both fail loudly on any
undeclared drift, which is the whole point: a renamed or retyped report
field must be a reviewed schema change, not a silent bench breakage.

The port reports the reference's schema unchanged plus the keys in
``PORT_EXTRAS`` (the device it ran on, each kernel's launch count and
the compiled step's first calls, captures and replays);
``diff_schema`` takes those as declared and reports any other drift.
Its ``kv`` / ``slab`` flags follow the substrate, as in the reference:
``pool.*`` on the attention and hybrid substrates, ``state_pool.*`` on
the recurrent and hybrid ones (a pure recurrent engine has no KV pool).

Conditional sections: ``speculative.*`` metrics exist only when
``spec_k > 0``, ``prefix_cache.*`` only when the cache is on (the report
surfaces the disabled sections as literal ``None``); ``profile`` exists
only when profiling is enabled and is dynamic; ``slo.*`` only when an
SLO monitor is configured (DESIGN §15).  ``diff_schema`` takes the
engine's feature flags into account so a cache-off engine isn't
reported as "missing" the cache section.
"""
from __future__ import annotations

__all__ = ["GOLDEN_SCHEMA", "PORT_EXTRAS", "DYNAMIC_KEYS",
           "SECTION_FLAGS", "schema_of", "diff_schema"]

# report keys whose VALUE shape is dynamic (per-dispatched-shape /
# per-profile / per-objective / per-kernel subdicts) — typed as dict,
# contents not golden
DYNAMIC_KEYS = ("step_shapes", "profile", "slo.status", "kernel_launches")

# the keys only the port reports, on top of GOLDEN_SCHEMA
PORT_EXTRAS = {
    "device": {"kind": "gauge", "type": "str"},
    "kernel_launches": {"kind": "gauge", "type": "dict"},
    "step_graphs": {"kind": "gauge", "type": "dict"},
}

# prefix -> engine feature that must be on for the section to register
SECTION_FLAGS = {"speculative.": "spec", "prefix_cache.": "cache",
                 "profile": "profile", "slo.": "slo",
                 "pool.": "kv", "state_pool.": "slab"}

GOLDEN_SCHEMA = {
    "n_requests": {"kind": "counter", "type": "int"},
    "completed": {"kind": "counter", "type": "int"},
    "preemptions": {"kind": "counter", "type": "int"},
    "gen_tokens": {"kind": "counter", "type": "int"},
    "prompt_tokens": {"kind": "counter", "type": "int"},
    "wall_s": {"kind": "gauge", "type": "float", "unit": "s"},
    "tokens_per_s": {"kind": "gauge", "type": "float", "optional": True},
    "decode_steps": {"kind": "counter", "type": "int"},
    "spec_steps": {"kind": "counter", "type": "int"},
    "prefill_chunks": {"kind": "counter", "type": "int"},
    "ragged": {"kind": "gauge", "type": "bool"},
    "ragged_steps": {"kind": "counter", "type": "int"},
    "substrate": {"kind": "gauge", "type": "str"},
    "recurrent_steps": {"kind": "counter", "type": "int"},
    "dispatched_tokens": {"kind": "counter", "type": "int"},
    "padded_tokens": {"kind": "counter", "type": "int"},
    "padding_frac": {"kind": "gauge", "type": "float", "optional": True},
    "speculative.spec_k": {"kind": "gauge", "type": "int"},
    "speculative.drafter": {"kind": "gauge", "type": "str"},
    "speculative.verify_steps": {"kind": "counter", "type": "int"},
    "speculative.fallback_decode_steps": {"kind": "counter", "type": "int"},
    "speculative.drafted_tokens": {"kind": "counter", "type": "int"},
    "speculative.accepted_tokens": {"kind": "counter", "type": "int"},
    "speculative.acceptance_rate":
        {"kind": "gauge", "type": "float", "optional": True},
    "speculative.emitted_tokens": {"kind": "counter", "type": "int"},
    "speculative.tokens_per_step":
        {"kind": "gauge", "type": "float", "optional": True},
    "speculative.retracts":
        {"kind": "counter", "type": "int", "alias_of": "pool.retracts"},
    "speculative.retracted_blocks":
        {"kind": "counter", "type": "int",
         "alias_of": "pool.retracted_blocks"},
    "speculative.requant_ops_wasted": {"kind": "counter", "type": "int"},
    "speculative.drafter_calls": {"kind": "counter", "type": "int"},
    "speculative.drafter_proposed": {"kind": "counter", "type": "int"},
    "speculative.drafter_empty": {"kind": "counter", "type": "int"},
    "ttft_s.p50":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "ttft_s.p99":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "tpot_s.p50":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "tpot_s.p99":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "e2e_s.p50":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "e2e_s.p99":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "step_shapes": {"kind": "gauge", "type": "dict"},
    "pool.num_blocks": {"kind": "gauge", "type": "int"},
    "pool.block_size": {"kind": "gauge", "type": "int"},
    "pool.peak_live_blocks": {"kind": "gauge", "type": "int"},
    "pool.peak_utilization": {"kind": "gauge", "type": "float"},
    "pool.utilization": {"kind": "gauge", "type": "float"},
    "pool.residency": {"kind": "gauge", "type": "float"},
    "pool.allocs": {"kind": "counter", "type": "int"},
    "pool.frees": {"kind": "counter", "type": "int"},
    "pool.evictions": {"kind": "counter", "type": "int"},
    "pool.seq_evictions": {"kind": "counter", "type": "int"},
    "pool.cache_evictions": {"kind": "counter", "type": "int"},
    "pool.retracts": {"kind": "counter", "type": "int"},
    "pool.retracted_blocks": {"kind": "counter", "type": "int"},
    "pool.alloc_failures": {"kind": "counter", "type": "int"},
    "state_pool.num_slabs": {"kind": "gauge", "type": "int"},
    "state_pool.scale_exp": {"kind": "gauge", "type": "int"},
    "state_pool.state_quant_ops_per_step": {"kind": "gauge", "type": "int"},
    "state_pool.requant_ops_state": {"kind": "counter", "type": "int"},
    "state_pool.state_ops_per_token":
        {"kind": "gauge", "type": "float", "optional": True},
    "state_pool.peak_live_slabs": {"kind": "gauge", "type": "int"},
    "state_pool.utilization": {"kind": "gauge", "type": "float"},
    "state_pool.allocs": {"kind": "counter", "type": "int"},
    "state_pool.frees": {"kind": "counter", "type": "int"},
    "state_pool.seq_evictions": {"kind": "counter", "type": "int"},
    "state_pool.alloc_failures": {"kind": "counter", "type": "int"},
    "prefix_cache.hits": {"kind": "counter", "type": "int"},
    "prefix_cache.misses": {"kind": "counter", "type": "int"},
    "prefix_cache.hit_rate": {"kind": "gauge", "type": "float"},
    "prefix_cache.hit_tokens": {"kind": "counter", "type": "int"},
    "prefix_cache.lookup_tokens": {"kind": "counter", "type": "int"},
    "prefix_cache.token_hit_rate": {"kind": "gauge", "type": "float"},
    "prefix_cache.cached_prefill_tokens": {"kind": "counter", "type": "int"},
    "prefix_cache.cow_copies": {"kind": "counter", "type": "int"},
    "prefix_cache.published_blocks": {"kind": "counter", "type": "int"},
    "prefix_cache.cache_evictions": {"kind": "counter", "type": "int"},
    "prefix_cache.resident_cached_blocks": {"kind": "gauge", "type": "int"},
    "prefix_cache.quant_ops_avoided": {"kind": "counter", "type": "int"},
    "hwcost.requant_ops_performed": {"kind": "counter", "type": "int"},
    "hwcost.requant_ops_avoided": {"kind": "counter", "type": "int"},
    "hwcost.requant_ops_avoided_prefix_cache":
        {"kind": "counter", "type": "int"},
    "hwcost.requant_ops_wasted_speculation":
        {"kind": "counter", "type": "int"},
    "hwcost.requant_ops_per_token":
        {"kind": "gauge", "type": "float", "optional": True},
    "hwcost.energy_uj_bit_shift":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "hwcost.energy_uj_if_requant_per_step":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "hwcost.energy_uj_if_no_prefix_cache":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "hwcost.energy_uj_if_scaling_factor":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "hwcost.w8a8": {"kind": "gauge", "type": "bool"},
    "hwcost.forward_quant_ops_per_token": {"kind": "gauge", "type": "int"},
    "hwcost.requant_ops_forward": {"kind": "counter", "type": "int"},
    "hwcost.requant_ops_forward_avoided_prefix_cache":
        {"kind": "counter", "type": "int"},
    "hwcost.requant_ops_forward_wasted_speculation":
        {"kind": "counter", "type": "int"},
    "hwcost.energy_uj_forward_bit_shift":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "hwcost.energy_uj_forward_if_scaling_factor":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "energy.unit": {"kind": "gauge", "type": "str"},
    "energy.prefill.quant_ops": {"kind": "counter", "type": "int"},
    "energy.prefill.tokens": {"kind": "counter", "type": "int"},
    "energy.prefill.energy_uj":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "energy.prefill.uj_per_token":
        {"kind": "gauge", "type": "float", "unit": "uJ", "optional": True},
    "energy.decode.quant_ops": {"kind": "counter", "type": "int"},
    "energy.decode.tokens": {"kind": "counter", "type": "int"},
    "energy.decode.energy_uj":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "energy.decode.uj_per_token":
        {"kind": "gauge", "type": "float", "unit": "uJ", "optional": True},
    "energy.spec_wasted.quant_ops": {"kind": "counter", "type": "int"},
    "energy.spec_wasted.tokens": {"kind": "counter", "type": "int"},
    "energy.spec_wasted.energy_uj":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "energy.spec_wasted.uj_per_token":
        {"kind": "gauge", "type": "float", "unit": "uJ", "optional": True},
    "energy.total_quant_ops": {"kind": "counter", "type": "int"},
    "energy.total_energy_uj":
        {"kind": "gauge", "type": "float", "unit": "uJ"},
    "energy.proxy_uj_per_token":
        {"kind": "gauge", "type": "float", "unit": "uJ", "optional": True},
    "timeline.source": {"kind": "gauge", "type": "str"},
    "timeline.requests": {"kind": "gauge", "type": "int"},
    "timeline.completed": {"kind": "gauge", "type": "int"},
    "timeline.ttft_s.p50":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "timeline.ttft_s.p99":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "timeline.tpot_s.p50":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "timeline.tpot_s.p99":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "timeline.e2e_s.p50":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "timeline.e2e_s.p99":
        {"kind": "gauge", "type": "float", "unit": "s", "optional": True},
    "obs.trace_enabled": {"kind": "gauge", "type": "bool"},
    "obs.trace_events": {"kind": "gauge", "type": "int"},
    "obs.trace_emitted": {"kind": "counter", "type": "int"},
    "obs.trace_dropped": {"kind": "counter", "type": "int"},
    "obs.trace_capacity": {"kind": "gauge", "type": "int"},
    "obs.trace_dropped_total":
        {"kind": "counter", "type": "int",
         "alias_of": "obs.trace_dropped"},
    "obs.trace_ring_used": {"kind": "gauge", "type": "float"},
    "slo.objectives": {"kind": "gauge", "type": "int"},
    "slo.evaluations": {"kind": "counter", "type": "int"},
    "slo.alerts_fired": {"kind": "counter", "type": "int"},
    "slo.alerts_active": {"kind": "gauge", "type": "int"},
    "slo.worst_burn_rate":
        {"kind": "gauge", "type": "float", "optional": True},
    "slo.status": {"kind": "gauge", "type": "dict"},
    "profile":
        {"kind": "gauge", "type": "dict", "optional": True},
}


def schema_of(registry) -> dict[str, dict]:
    """Project a registry's :meth:`describe` down to the golden identity
    fields (paste the output here to regenerate after a reviewed
    change)."""
    out = {}
    for name, d in registry.describe().items():
        e = {"kind": d["kind"], "type": d["type"]}
        if d.get("unit"):
            e["unit"] = d["unit"]
        if d.get("optional"):
            e["optional"] = True
        if d.get("alias_of"):
            e["alias_of"] = d["alias_of"]
        out[name] = e
    return out


def _section_on(name: str, features: dict) -> bool:
    for prefix, flag in SECTION_FLAGS.items():
        if name == prefix or name.startswith(prefix):
            return bool(features.get(flag, False))
    return True


def diff_schema(got: dict, golden: dict = None, *,
                spec: bool = True, cache: bool = True,
                profile: bool = False, slo: bool = False,
                kv: bool = True, slab: bool = False,
                extras: dict = None) -> list[str]:
    """Human-readable differences between an engine's projected schema
    and the golden one, respecting which conditional sections the
    engine's feature flags enable.  Empty list == schema-clean.
    ``kv``/``slab`` mirror the substrate (DESIGN §16): ``pool.*`` exists
    on the growing substrates (attention/hybrid), ``state_pool.*`` on the
    fixed-state ones (recurrent/hybrid).  ``extras`` (default
    ``PORT_EXTRAS``) are declared keys outside the golden schema: each
    must be present with its declared identity; pass ``{}`` to diff a
    registry that carries none (the JAX package's)."""
    golden = GOLDEN_SCHEMA if golden is None else golden
    extras = PORT_EXTRAS if extras is None else extras
    feats = {"spec": spec, "cache": cache, "profile": profile,
             "slo": slo, "kv": kv, "slab": slab}
    errs = []
    for name, want in golden.items():
        if not _section_on(name, feats):
            if name in got:
                errs.append(f"{name}: registered but its section is off")
            continue
        have = got.get(name)
        if have is None:
            errs.append(f"{name}: missing from registry")
        elif have != want:
            errs.append(f"{name}: {have} != golden {want}")
    for name, want in extras.items():
        have = got.get(name)
        if have is None:
            errs.append(f"{name}: declared in PORT_EXTRAS, missing from "
                        f"registry")
        elif have != want:
            errs.append(f"{name}: {have} != PORT_EXTRAS {want}")
    for name in got:
        if name not in golden and name not in extras:
            errs.append(f"{name}: registered but not in GOLDEN_SCHEMA — "
                        f"document it (kind/type/unit) or remove it")
    return errs
