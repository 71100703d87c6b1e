"""Uniform parsing for the HYDRAGNN_* env-flag layer — the subset the
port reads (counterpart: hydragnn_tpu/utils/envflags.py, whose parsing
rules this copy keeps: strict helpers warn on a typo and fall back to the
default instead of taking effect)."""
from __future__ import annotations

import logging
import os

_FALSY = ("", "0", "false", "no", "off")
_TRUTHY_STRICT = ("1", "true", "on")

_log = logging.getLogger("hydragnn_tpu_torch")


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env flag: unset -> default; '0'/'false'/'no'/'off' (any
    case) -> False; anything else -> True."""
    val = os.getenv(name)
    if val is None:
        return default
    return val.strip().lower() not in _FALSY


def env_str(name: str, default=None):
    """String env knob: unset or whitespace-only -> `default`, otherwise
    the stripped value."""
    val = os.getenv(name)
    if val is None:
        return default
    val = val.strip()
    return val if val else default


def env_strict_flag(name: str, default: bool = False) -> bool:
    """Only '1'/'true'/'on' enable and '0'/'false'/'off'/'no'/'' disable;
    anything else warns and returns `default`."""
    val = os.getenv(name)
    if val is None:
        return default
    v = val.strip().lower()
    if v in _TRUTHY_STRICT:
        return True
    if v in _FALSY:
        return False
    _log.warning("%s=%r is not a recognized boolean (use 1/true/on or "
                 "0/false/off); treating as %s", name, val, default)
    return default


def env_int(name: str, default=None):
    """Integer env knob: unset or whitespace-only -> `default`, otherwise
    int(value); a value that is not an integer raises ValueError."""
    val = os.getenv(name)
    if val is None or not val.strip():
        return default
    return int(val)


def _env_strict_number(name: str, default, conv, kind: str):
    val = os.getenv(name)
    if val is None or not val.strip():
        return default
    try:
        return conv(val.strip())
    except ValueError:
        _log.warning("%s=%r is not %s; treating as %r", name, val, kind,
                     default)
        return default


def env_strict_int(name: str, default=None):
    return _env_strict_number(name, default, int, "an integer")


def env_strict_float(name: str, default=None):
    return _env_strict_number(name, default, float, "a number")


def env_strict_choice(name: str, choices, default=None):
    """String env knob restricted to a canonical choice set: `choices`
    maps accepted (lowercased) spellings to canonical values. An
    unrecognized value warns and returns `default` instead of taking
    effect, so a typo never changes the compute dtype silently."""
    val = os.getenv(name)
    if val is None or not val.strip():
        return default
    v = val.strip().lower()
    if v in choices:
        return choices[v]
    _log.warning("%s=%r is not one of %s; treating as %r", name, val,
                 sorted(set(choices)), default)
    return default


_LOADER_RETRY_MEMO: dict = {}


def resolve_loader_retries() -> "tuple[int, float]":
    """(attempts, backoff_base_s) of the loader's retry over transient
    I/O (datasets/loader.fetch_samples; counterpart:
    hydragnn_tpu/utils/envflags.py): HYDRAGNN_LOADER_RETRIES tries a
    fetch at most (default 3, at least 1), HYDRAGNN_LOADER_RETRY_BACKOFF_S
    is the first wait (default 0.05 s, doubling a retry, capped at 1 s by
    the loop). Strict: a typo warns and keeps the default. Memoized on
    the raw strings, so a typo warns once a value, not once a batch."""
    key = (os.getenv("HYDRAGNN_LOADER_RETRIES"),
           os.getenv("HYDRAGNN_LOADER_RETRY_BACKOFF_S"))
    hit = _LOADER_RETRY_MEMO.get(key)
    if hit is None:
        attempts = env_strict_int("HYDRAGNN_LOADER_RETRIES", 3)
        backoff = env_strict_float("HYDRAGNN_LOADER_RETRY_BACKOFF_S", 0.05)
        hit = (max(int(attempts), 1), max(float(backoff), 0.0))
        _LOADER_RETRY_MEMO[key] = hit
    return hit


def resolve_rendezvous_timeout() -> "float | None":
    """HYDRAGNN_RENDEZVOUS_TIMEOUT_S: how long `parallel.mesh.
    init_distributed` and `parallel.multiprocess.
    assert_equal_across_processes` wait for peer processes before raising
    an actionable error (counterpart: hydragnn_tpu/utils/envflags.py).
    Strict parsing; unset or <= 0 is None (unbounded)."""
    t = env_strict_float("HYDRAGNN_RENDEZVOUS_TIMEOUT_S")
    if t is None:
        return None
    t = float(t)
    return t if t > 0 else None


def resolve_packing(train_cfg) -> bool:
    """Budget-packed batching: HYDRAGNN_PACKING, when set, overrides
    Training.batch_packing (default off). Parsed strictly: a typo warns
    and keeps the config's value (counterpart:
    hydragnn_tpu/utils/envflags.py `resolve_packing`)."""
    return env_strict_flag("HYDRAGNN_PACKING",
                           bool(train_cfg.get("batch_packing", False)))


def resolve_steps_per_call(train_cfg) -> int:
    """Train steps per dispatch: HYDRAGNN_STEPS_PER_CALL, when set,
    overrides Training.steps_per_call (default 1) (counterpart:
    hydragnn_tpu/utils/envflags.py `resolve_steps_per_call`)."""
    spc_env = env_int("HYDRAGNN_STEPS_PER_CALL")
    if spc_env is not None:
        return spc_env
    return int(train_cfg.get("steps_per_call", 1))


def resolve_pack_lookahead(train_cfg):
    """The pack planner's first-fit-decreasing window:
    HYDRAGNN_PACK_LOOKAHEAD, when set, overrides Training.pack_lookahead;
    None leaves the planner's default (counterpart:
    hydragnn_tpu/utils/envflags.py `resolve_pack_lookahead`)."""
    la = env_int("HYDRAGNN_PACK_LOOKAHEAD")
    if la is not None:
        return la
    la = train_cfg.get("pack_lookahead")
    return None if la is None else int(la)


def resolve_preproc_workers(train_cfg=None) -> int:
    """Preprocessing workers: HYDRAGNN_PREPROC_WORKERS over
    Training.preprocess_workers, default 0; 0 and 1 both build serially.
    Parsed strictly: a typo warns and keeps the default (counterpart:
    hydragnn_tpu/utils/envflags.py `resolve_preproc_workers`)."""
    w = env_strict_int("HYDRAGNN_PREPROC_WORKERS")
    if w is None and train_cfg:
        w = train_cfg.get("preprocess_workers")
    return max(int(w), 0) if w is not None else 0


def resolve_preproc_cache_dir(ds_cfg=None):
    """The preprocessed-sample cache directory:
    HYDRAGNN_PREPROC_CACHE_DIR over Dataset.preprocessed_cache_dir; unset
    or empty is None, the cache off (counterpart:
    hydragnn_tpu/utils/envflags.py `resolve_preproc_cache_dir`)."""
    d = os.getenv("HYDRAGNN_PREPROC_CACHE_DIR")
    if d is None and ds_cfg:
        d = ds_cfg.get("preprocessed_cache_dir")
    d = (d or "").strip()
    return d or None


def resolve_telemetry(train_cfg=None):
    """The training telemetry knobs -> telemetry.session.TelemetryConfig
    (counterpart: hydragnn_tpu/utils/envflags.py `resolve_telemetry`):
    env over the Training.Telemetry block over off, parsed strictly (a
    typo warns and keeps the block's value, so telemetry never turns on
    from one).

      HYDRAGNN_TELEMETRY            the session (telemetry.jsonl,
                                    trace.json, metrics.prom)
      HYDRAGNN_TELEMETRY_DIR        artifact directory (default
                                    <run dir>/telemetry)
      HYDRAGNN_DEVICE_TRACE         a torch.profiler trace of one epoch,
                                    with or without the session
      HYDRAGNN_DEVICE_TRACE_EPOCH   the epoch it captures (default 0)
    """
    from ..telemetry.session import TelemetryConfig
    block = (train_cfg or {}).get("Telemetry", {}) or {}
    out_dir = os.getenv("HYDRAGNN_TELEMETRY_DIR")
    if out_dir is None:
        out_dir = block.get("dir")
    out_dir = (out_dir or "").strip() or None
    return TelemetryConfig(
        enabled=env_strict_flag("HYDRAGNN_TELEMETRY",
                                bool(block.get("enabled", False))),
        out_dir=out_dir,
        device_trace=env_strict_flag("HYDRAGNN_DEVICE_TRACE",
                                     bool(block.get("device_trace",
                                                    False))),
        device_trace_epoch=int(env_strict_int(
            "HYDRAGNN_DEVICE_TRACE_EPOCH",
            int(block.get("device_trace_epoch", 0) or 0))),
    )


# the remat knob's spellings: off, full rematerialization, or "dots"
# (keep the matrix products' outputs)
_REMAT_SPELLINGS = {"0": None, "false": None, "off": None, "no": None,
                    "1": "full", "true": "full", "on": "full",
                    "full": "full", "dots": "dots"}


def resolve_pipeline(train_cfg, num_stages: int):
    """The pipeline knobs -> (microbatches, schedule, remat policy or
    None, data shards) (counterpart: hydragnn_tpu/utils/envflags.py
    `resolve_pipeline`). Env over the Training.* keys over the defaults,
    parsed strictly: a typo warns and falls back to the layer below.

      HYDRAGNN_PIPE_MICROBATCHES  microbatches a step
                                  (Training.pipeline_microbatches;
                                  default: pipeline_stages)
      HYDRAGNN_PIPE_SCHEDULE      gpipe | 1f1b (Training.pipeline_schedule;
                                  default 1f1b)
      HYDRAGNN_PIPE_REMAT         0/off | 1/full | dots
                                  (Training.pipeline_remat; default off)

    A defaulted 1f1b whose microbatches are not a multiple of the stages
    (and more than them) falls back to gpipe with a warning; an explicit
    1f1b is left for the config check to refuse. Data shards
    (Training.pipeline_data_shards) are config-only."""
    train_cfg = train_cfg or {}
    micro_default = int(train_cfg.get("pipeline_microbatches",
                                      num_stages) or num_stages)
    microbatches = env_strict_int("HYDRAGNN_PIPE_MICROBATCHES",
                                  micro_default)
    # explicit means a valid choice: a typo'd or empty env value falls
    # back and keeps the compatibility fall-back below
    sched_env = (os.getenv("HYDRAGNN_PIPE_SCHEDULE") or "").strip().lower()
    sched_cfg = str(train_cfg.get("pipeline_schedule") or "").strip().lower()
    sched_explicit = sched_env in ("gpipe", "1f1b") or bool(sched_cfg)
    schedule = env_strict_choice(
        "HYDRAGNN_PIPE_SCHEDULE", {"gpipe": "gpipe", "1f1b": "1f1b"},
        sched_cfg or "1f1b")
    if (schedule == "1f1b" and not sched_explicit and num_stages > 0
            and microbatches > num_stages and microbatches % num_stages):
        _log.warning(
            "pipeline_microbatches=%d is not a multiple of "
            "pipeline_stages=%d, which the default 1f1b schedule cannot "
            "window — falling back to gpipe (O(M) live activations). "
            "Set Training.pipeline_schedule/HYDRAGNN_PIPE_SCHEDULE "
            "explicitly to silence this.", microbatches, num_stages)
        schedule = "gpipe"
    remat_default = train_cfg.get("pipeline_remat", False)
    if isinstance(remat_default, bool):
        default_policy = "full" if remat_default else None
    else:
        key = str(remat_default).strip().lower()
        if key and key not in _REMAT_SPELLINGS:
            _log.warning("Training.pipeline_remat=%r is not one of %s; "
                         "treating as off", remat_default,
                         sorted(set(_REMAT_SPELLINGS)))
        default_policy = _REMAT_SPELLINGS.get(key)
    policy = env_strict_choice("HYDRAGNN_PIPE_REMAT", _REMAT_SPELLINGS,
                               default_policy)
    data_shards = int(train_cfg.get("pipeline_data_shards", 1) or 1)
    return int(microbatches), schedule, policy, data_shards


def resolve_gfm(train_cfg=None) -> "tuple":
    """The GFM mixture knobs (counterpart: hydragnn_tpu/utils/envflags.py
    `resolve_gfm`) -> (mixture weights {name: weight} or None, per-head
    loss weights tuple or None); None leaves the loader's and the step's
    defaults (size-proportional sampling, the config's task_weights).

    Each knob: HYDRAGNN_GFM_MIXTURE / HYDRAGNN_GFM_HEAD_WEIGHTS over the
    Training.Gfm block's `mixture` / `head_weights` over None. The env is
    parsed strictly: a malformed value warns, naming the variable, and
    keeps the block's value.

      HYDRAGNN_GFM_MIXTURE       comma-separated `name:weight` pairs
                                 ("alpha:2,beta", a missing weight 1.0),
                                 each weight positive and finite;
      HYDRAGNN_GFM_HEAD_WEIGHTS  comma-separated weights, one a head,
                                 each non-negative and finite.

    Resolved once, where a driver builds its loader and step:
    parallel/multidataset.py and train/gfm.py read no environment."""
    import math
    block = (train_cfg or {}).get("Gfm", {}) or {}

    mixture = None
    if block.get("mixture"):
        mixture = {str(k): float(v) for k, v in block["mixture"].items()}
    raw = os.getenv("HYDRAGNN_GFM_MIXTURE")
    if raw is not None and raw.strip():
        try:
            parsed = {}
            for part in raw.split(","):
                part = part.strip()
                if not part:
                    continue
                name, _, w = part.partition(":")
                if not name.strip():
                    raise ValueError
                weight = float(w) if w.strip() else 1.0
                if not (weight > 0) or not math.isfinite(weight):
                    raise ValueError
                parsed[name.strip()] = weight
            if not parsed:
                raise ValueError
            mixture = parsed
        except ValueError:
            _log.warning(
                "HYDRAGNN_GFM_MIXTURE=%r is not a comma-separated list "
                "of name:positive-weight pairs; treating as %r", raw,
                mixture)

    head_weights = None
    if block.get("head_weights"):
        head_weights = tuple(float(v) for v in block["head_weights"])
    raw = os.getenv("HYDRAGNN_GFM_HEAD_WEIGHTS")
    if raw is not None and raw.strip():
        try:
            parsed = tuple(float(p.strip()) for p in raw.split(","))
            if not parsed or any(not math.isfinite(w) or w < 0
                                 for w in parsed):
                raise ValueError
            head_weights = parsed
        except ValueError:
            _log.warning(
                "HYDRAGNN_GFM_HEAD_WEIGHTS=%r is not a comma-separated "
                "list of non-negative weights; treating as %r", raw,
                head_weights)
    return mixture, head_weights


def resolve_sampling(train_cfg=None) -> "tuple[tuple, int, int, str]":
    """The sampled-training knobs (counterpart: hydragnn_tpu/utils/
    envflags.py `resolve_sampling`) -> (fanouts, staleness_k, partitions,
    partition_mode).

    Each knob: HYDRAGNN_SAMPLE_* over the Training.Sampling block over the
    default. Parsing is strict: a malformed value warns, naming the
    variable, and keeps the block's value (fanouts change every shape of
    the run and staleness_k its mathematics).

      HYDRAGNN_SAMPLE_FANOUTS      comma-separated positive per-hop
                                   fanouts, "10,5" (Sampling.fanouts;
                                   default 8,8)
      HYDRAGNN_SAMPLE_STALENESS_K  the historical cache's refresh period,
                                   0 = exact (Sampling.staleness_k;
                                   default 0)
      HYDRAGNN_SAMPLE_PARTITIONS   feature / owner partitions
                                   (Sampling.partitions; default 1)

    The partition mode (range | hash) is config-only
    (Sampling.partition_mode). Resolved once, where a driver builds its
    loader: preprocess/sampling.py reads no environment."""
    block = (train_cfg or {}).get("Sampling", {}) or {}
    fan_default = tuple(int(f) for f in block.get("fanouts", (8, 8)))
    fanouts = fan_default
    raw = os.getenv("HYDRAGNN_SAMPLE_FANOUTS")
    if raw is not None and raw.strip():
        try:
            parsed = tuple(int(p.strip()) for p in raw.split(","))
            if not parsed or any(f <= 0 for f in parsed):
                raise ValueError
            fanouts = parsed
        except ValueError:
            _log.warning(
                "HYDRAGNN_SAMPLE_FANOUTS=%r is not a comma-separated "
                "list of positive integers; treating as %r", raw,
                fan_default)
    k = env_strict_int("HYDRAGNN_SAMPLE_STALENESS_K",
                       int(block.get("staleness_k", 0)))
    parts = env_strict_int("HYDRAGNN_SAMPLE_PARTITIONS",
                           int(block.get("partitions", 1)))
    mode = str(block.get("partition_mode", "range"))
    return fanouts, max(int(k), 0), max(int(parts), 1), mode
