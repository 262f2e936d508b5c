"""Prepared-statement serving subsystem (port of snappydata_tpu/serving).

`prepared.py` — compile-once parameterized plans: a per-catalog registry
of analyzed + tokenized query shapes whose `?` binds are runtime
literals of one compiled plan (`session.prepare(sql)`, SQL `PREPARE name
AS ... / EXECUTE name (...)`).

`batcher.py` — adaptive micro-batching: concurrent executes of one
prepared plan fuse into one dispatch over one bind with one host copy
(`serving_batch_max` / `serving_batch_wait_us`), with per-request
admission, cancellation and timeouts intact.
"""

from snappydata_tpu_torch.serving.prepared import (PreparedStatement,
                                             PreparedPlan, ServingError,
                                             ServingRegistry, registry_for,
                                             serving_registry_nbytes)
from snappydata_tpu_torch.serving.batcher import global_batcher

__all__ = ["PreparedStatement", "PreparedPlan", "ServingError",
           "ServingRegistry", "registry_for", "serving_registry_nbytes",
           "global_batcher", "serving_snapshot"]


def serving_snapshot(catalog=None) -> dict:
    """Serving-path stats for REST `GET /status/api/v1/serving` and the
    dashboard: live knobs, registry population, and the counters that
    prove the two claims — serving_prepared_hits (executes that skipped
    parse/analyze/tokenize entirely) and serving_batched_dispatches /
    serving_batch_occupancy (how many requests shared one device
    dispatch)."""
    from snappydata_tpu_torch import config
    from snappydata_tpu_torch.observability.metrics import global_registry

    c = global_registry().snapshot()
    props = config.global_properties()
    dispatches = c.get("serving_batched_dispatches", 0)
    fused = c.get("serving_batch_requests", 0)
    out = {
        "serving_batch_max": props.get("serving_batch_max"),
        "serving_batch_wait_us": props.get("serving_batch_wait_us"),
        "serving_max_handles": props.get("serving_max_handles"),
        "serving_prepared_hits": c.get("serving_prepared_hits", 0),
        "serving_prepared_misses": c.get("serving_prepared_misses", 0),
        "serving_reprepares": c.get("serving_reprepares", 0),
        "serving_passthrough": c.get("serving_passthrough", 0),
        "serving_batched_dispatches": dispatches,
        "serving_batch_requests": fused,
        "serving_batch_occupancy":
            round(fused / dispatches, 2) if dispatches else None,
        "serving_straight_through": c.get("serving_straight_through", 0),
        "serving_batch_fallbacks": c.get("serving_batch_fallbacks", 0),
        "serving_vmap_compiles": c.get("serving_vmap_compiles", 0),
        "serving_bulk_transfers": c.get("serving_bulk_transfers", 0),
        "serving_handle_evictions": c.get("serving_handle_evictions", 0),
        "plan_cache_evictions": c.get("plan_cache_evictions", 0),
        "serving_registry_nbytes": serving_registry_nbytes(),
    }
    if catalog is not None:
        reg = getattr(catalog, "_serving_registry", None)
        out["handles"] = reg.describe() if reg is not None else []
    return out
