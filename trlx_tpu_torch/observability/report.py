"""Performance report generator (the counterpart of
``trlx_tpu.observability.report``, a copy of its rendering): a run's
``metrics.jsonl``, span files, ``programs.json``, ``graftscope.json``, fleet
artifacts and incident bundles → one markdown document.

    python -m trlx_tpu_torch.observability.report <checkpoint_dir> [-o report.md]
                                                  [--trace-out trace.json]

Sections: the run summary, the per-window phase breakdown, the MFU trend
(from the FLOPs ``observability.devicemon`` counted), staleness, kernel
routing with the monitored programs, span lanes (and the producer/train
overlap), the graftscope ledger and time sinks, the fleet, graftnum's
numerics (subtree table, quantization error, NaN provenance), training
health and the incident index. ``--trace-out`` writes the spans as a
``{"traceEvents": [...]}`` file for chrome://tracing. ``learn()`` writes
``<checkpoint_dir>/report.md`` at the end of a run with device telemetry,
graftscope or graftnum armed.

``rollup_window_stats`` aggregates one window's scalars over the processes
(``parallel.mesh.allgather_host``): every process calls it at the same
boundary.
"""

import argparse
import json
import os
import warnings
from collections import defaultdict

import numpy as np

__all__ = ["build_report", "rollup_window_stats", "main"]


# ------------------------------------------------------------------ rollup


def rollup_window_stats(stats: dict, per_host: bool = False) -> dict:
    """Aggregate one window's scalar stats across hosts.

    Returns ``{key/hostmean, key/hostmax}`` for every float-valued key, via
    ``allgather_host`` — so it MUST be called collectively (every host, same
    window boundary). Identity-shaped at process_count()==1: the mean/max of
    one host is itself (tests exercise this path; pods get the real gather).

    ``per_host=True`` (graftfleet armed — must be config-consistent, the
    flag changes nothing about the gather itself) additionally emits every
    host's own value as ``fleet/host{k}/<key>`` plus ``key/hostmin`` /
    ``key/hostspread`` fleet-level views, all from the SAME gathered matrix
    — no extra collective."""
    from trlx_tpu_torch.parallel.mesh import allgather_host, world_size

    keys = sorted(k for k, v in stats.items() if isinstance(v, (int, float)))
    if not keys:
        return {}
    row = np.asarray([float(stats[k]) for k in keys], dtype=np.float64)
    if world_size() == 1:
        gathered = row[None, :]
    else:
        gathered = np.asarray(allgather_host(row[None, :])).reshape(-1, len(keys))
    out = {}
    for j, key in enumerate(keys):
        out[f"{key}/hostmean"] = float(gathered[:, j].mean())
        out[f"{key}/hostmax"] = float(gathered[:, j].max())
        if per_host:
            out[f"{key}/hostmin"] = float(gathered[:, j].min())
            out[f"{key}/hostspread"] = float(gathered[:, j].max() - gathered[:, j].min())
            for host in range(gathered.shape[0]):
                out[f"fleet/host{host}/{key}"] = float(gathered[host, j])
    return out


# ----------------------------------------------------------------- loading


def _load_jsonl(path):
    from trlx_tpu_torch.utils.jsonl import read_jsonl

    if not os.path.exists(path):
        return []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torn tails are routine post-kill
        return read_jsonl(path)


def _scalar_records(metrics):
    return [r for r in metrics if "step" in r and "table" not in r and "histogram" not in r]


def _fmt(value, digits=3):
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:.{digits}f}"
    return str(value)


def _trend(values, width: int = 24) -> str:
    """Coarse text sparkline — enough to see an MFU ramp or collapse."""
    if not values:
        return ""
    marks = " .:-=+*#"
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    if len(values) > width:
        # Mean-pool to `width` buckets.
        idx = np.array_split(np.asarray(values, dtype=np.float64), width)
        values = [float(chunk.mean()) for chunk in idx if chunk.size]
    return "".join(marks[int((v - lo) / span * (len(marks) - 1))] for v in values)


# ----------------------------------------------------------------- spans


def _lane_summary(spans):
    """Per-(pid, tid) lane accounting + cross-lane overlap of X-events."""
    names = {}
    lanes = defaultdict(lambda: {"events": 0, "busy_us": 0, "top": defaultdict(int)})
    for event in spans:
        key = (event.get("pid", 0), event.get("tid", 0))
        if event.get("ph") == "M" and event.get("name") == "thread_name":
            names[key] = event.get("args", {}).get("name", "?")
        elif event.get("ph") == "X":
            lane = lanes[key]
            lane["events"] += 1
            lane["busy_us"] += int(event.get("dur", 0))
            lane["top"][event.get("name", "?")] += int(event.get("dur", 0))
    rows = []
    for key, lane in sorted(lanes.items()):
        top = max(lane["top"].items(), key=lambda kv: kv[1])[0] if lane["top"] else "-"
        rows.append(
            {
                "pid": key[0],
                "tid": key[1],
                "thread": names.get(key, "?"),
                "events": lane["events"],
                "busy_s": lane["busy_us"] / 1e6,
                "top_span": top,
            }
        )
    return rows


def _overlap_seconds(spans, lane_a_substr: str, lane_b_substr: str):
    """Wall seconds where an X-span on a thread named like A overlaps one on
    a thread named like B — the picture-level form of overlap_fraction."""
    names = {}
    for event in spans:
        if event.get("ph") == "M" and event.get("name") == "thread_name":
            names[(event.get("pid", 0), event.get("tid", 0))] = event.get("args", {}).get("name", "")

    def intervals(substr):
        out = []
        for event in spans:
            if event.get("ph") != "X":
                continue
            lane = names.get((event.get("pid", 0), event.get("tid", 0)), "")
            if substr in lane:
                t0 = event.get("ts", 0)
                out.append((t0, t0 + event.get("dur", 0)))
        out.sort()
        return out

    a, b = intervals(lane_a_substr), intervals(lane_b_substr)
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e6


# ------------------------------------------------------------- graftscope


def _sink_knob(name: str) -> str:
    """Suggested first knob for a named time sink."""
    if "bubble" in name:
        return "raise method.max_staleness / method.score_queue_depth (hide more rollout behind train)"
    if "refill" in name:
        return "raise method.prefill_batch or method.engine_slots (slots starve between episodes)"
    if "score" in name:
        return "parallelize the reward fn / raise method.score_queue_depth"
    if "producer" in name or "rollout" in name or "decode" in name or "engine" in name:
        return "raise method.engine_steps_per_sync / method.chunk_size (amortize decode sync)"
    if "train" in name:
        return "raise train.batch_size or relax remat (device train step dominates)"
    return "profile with spans.jsonl in Perfetto"


def _graftscope_section(checkpoint_dir):
    """Render graftscope.json (if the run was armed) into the ledger table,
    per-program attribution, slot occupancy rows, and the top-3 time sinks
    with a suggested knob each."""
    lines = ["## Device-time attribution (graftscope)", ""]
    path = os.path.join(checkpoint_dir, "graftscope.json")
    if not os.path.exists(path):
        lines.append("No graftscope snapshot (train.graftscope off — set it or TRLX_TPU_GRAFTSCOPE=1).")
        lines.append("")
        return lines
    try:
        with open(path) as f:
            snap = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        lines.append(f"graftscope.json unreadable: {e}")
        lines.append("")
        return lines
    totals = snap.get("totals", {})
    wall = totals.get("wall_s", 0.0) or 0.0
    lines.append("| wall_s | device_busy_s | host_s | bubble_s | bubble_frac | windows | fences dropped |")
    lines.append("|---|---|---|---|---|---|---|")
    lines.append(
        f"| {_fmt(wall, 2)} | {_fmt(totals.get('device_busy_s', 0.0), 2)} "
        f"| {_fmt(totals.get('host_s', 0.0), 2)} | {_fmt(totals.get('bubble_s', 0.0), 2)} "
        f"| {_fmt(snap.get('bubble_fraction', 0.0), 3)} | {len(snap.get('windows', []))} "
        f"| {snap.get('fences_dropped', 0)} |"
    )
    lines.append("")
    programs = snap.get("programs_s", {})
    if programs:
        lines.append("### Per-program device time (top-K, fence-measured)")
        lines.append("")
        lines.append("| program | device_s | share of wall |")
        lines.append("|---|---|---|")
        for name, sec in sorted(programs.items(), key=lambda kv: -kv[1]):
            share = sec / wall if wall else 0.0
            lines.append(f"| {name} | {_fmt(sec, 2)} | {_fmt(100 * share, 1)}% |")
        lines.append("")
    slots = snap.get("slots", [])
    if slots:
        lines.append("### Engine slot occupancy")
        lines.append("")
        lines.append("| slot | busy_s | episodes | last width |")
        lines.append("|---|---|---|---|")
        for row in slots:
            lines.append(
                f"| {row.get('slot')} | {_fmt(row.get('busy_s', 0.0), 2)} "
                f"| {row.get('episodes', 0)} | {row.get('last_width', 0)} |"
            )
        lines.append(
            f"\ncumulative refill wait: {_fmt(snap.get('refill_wait_total_ms', 0.0), 1)} ms"
        )
        lines.append("")
    # Top-3 time sinks: the window's non-overlapped seconds, ranked.
    sinks = [("pipeline bubble", totals.get("bubble_s", 0.0) or 0.0)]
    sinks += [(f"device: {name}", sec) for name, sec in list(programs.items())[:4]]
    for lane, sec in (snap.get("lane_busy_s", {}) or {}).items():
        sinks.append((f"host {lane} lane", sec or 0.0))
    refill_s = (snap.get("refill_wait_total_ms", 0.0) or 0.0) / 1e3
    if refill_s > 0:
        sinks.append(("engine refill wait", refill_s))
    sinks = sorted(sinks, key=lambda kv: -kv[1])[:3]
    lines.append("### Top-3 time sinks")
    lines.append("")
    lines.append("| sink | seconds | suggested knob |")
    lines.append("|---|---|---|")
    for name, sec in sinks:
        lines.append(f"| {name} | {_fmt(sec, 2)} | {_sink_knob(name)} |")
    lines.append("")
    return lines


# ----------------------------------------------------------------- fleet


def _fleet_section(checkpoint_dir):
    """Render graftfleet's federation artifacts: the merged multi-host
    timeline summary (with the stated clock-alignment bound), the
    per-collective skew table naming the worst-arrival host per site, and
    the per-host heartbeat summary."""
    from trlx_tpu_torch.observability import fleet as obs_fleet
    from trlx_tpu_torch.observability.spans import read_fleet_spans
    from trlx_tpu_torch.resilience.distributed import read_heartbeats

    lines = ["## Fleet (graftfleet)", ""]
    merged = read_fleet_spans(checkpoint_dir)
    arrivals = obs_fleet.read_collective_arrivals(checkpoint_dir)
    if merged["clock"] is None and not arrivals:
        lines.append("No fleet artifacts (train.graftfleet off — set it or TRLX_TPU_GRAFTFLEET=1).")
        lines.append("")
        return lines
    clock = merged["clock"] or {}
    offsets = clock.get("offsets_s", [])
    lines.append(
        f"- merged trace: {len(merged['traceEvents'])} events across host lane(s) "
        f"{merged['hosts']} · clock-alignment error ≤ {merged['alignment_error_s'] * 1e3:.3f}ms "
        f"(estimate uncertainty + drift, fleet_clock.jsonl step {clock.get('step', '?')})"
    )
    if offsets:
        lines.append(
            "- clock offsets vs host 0: "
            + " · ".join(f"host{k} {v * 1e3:+.3f}ms" for k, v in enumerate(offsets))
        )
    lines.append("")
    rows = obs_fleet.collective_skew_table(checkpoint_dir)
    if rows:
        lines.append("### Per-collective skew")
        lines.append("")
        lines.append("| site | occurrences | p50_ms | p95_ms | max_ms | worst host | worst share |")
        lines.append("|---|---|---|---|---|---|---|")
        for row in rows:
            worst = "-" if row["worst_host"] is None else f"host {row['worst_host']}"
            lines.append(
                f"| {row['site']} | {row['count']} | {_fmt(row['p50_ms'], 1)} "
                f"| {_fmt(row['p95_ms'], 1)} | {_fmt(row['max_ms'], 1)} "
                f"| {worst} | {_fmt(row['worst_share'], 2)} |"
            )
        lines.append("")
    beats = read_heartbeats(os.path.join(checkpoint_dir, "heartbeats"))
    if beats:
        lines.append("### Per-host heartbeat summary")
        lines.append("")
        lines.append("| host | last step | phase | progress_t | written_t |")
        lines.append("|---|---|---|---|---|")
        for host, rec in sorted(beats.items()):
            lines.append(
                f"| {host} | {rec.get('step')} | {rec.get('phase')} "
                f"| {_fmt(rec.get('progress_t'), 1)} | {_fmt(rec.get('written_t'), 1)} |"
            )
        lines.append("")
    incident = os.path.join(checkpoint_dir, "incidents")
    fleet_bundles = []
    if os.path.isdir(incident):
        for name in sorted(os.listdir(incident)):
            if os.path.exists(os.path.join(incident, name, "fleet_incident.json")):
                fleet_bundles.append(name)
    if fleet_bundles:
        lines.append(
            "- fleet incident bundles: "
            + " · ".join(f"`incidents/{name}/host<k>/`" for name in fleet_bundles)
        )
        lines.append("")
    return lines


def _numerics_section(checkpoint_dir, scalars):
    """Render graftnum's numerics artifacts: the global grad-norm trend,
    the per-subtree grad/update-ratio table, quantization-error gauges per
    kernel class, and the NaN-provenance verdict of every incident bundle
    that carries a numerics.json."""
    from trlx_tpu_torch.observability import numerics as obs_numerics

    lines = ["## Numerics (graftnum)", ""]
    num_keys = sorted({k for r in scalars for k in r if k.startswith("num/")})
    incidents_dir = os.path.join(checkpoint_dir, "incidents")
    numerics_bundles = []
    if os.path.isdir(incidents_dir):
        for name in sorted(os.listdir(incidents_dir)):
            path = os.path.join(incidents_dir, name, obs_numerics.NUMERICS_FILENAME)
            try:
                with open(path) as f:
                    numerics_bundles.append((name, json.load(f)))
            except (OSError, ValueError):
                continue
    if not num_keys and not numerics_bundles:
        lines.append("No numerics records (train.graftnum off — set it or TRLX_TPU_GRAFTNUM=1).")
        lines.append("")
        return lines
    gnorm = [float(r["num/grad_global_norm"]) for r in scalars if "num/grad_global_norm" in r]
    # NaN records are real data here (the guard-tripped step logs a NaN
    # norm) but poison min/max and the sparkline — count them, trend the rest.
    gnorm_bad = sum(1 for v in gnorm if not np.isfinite(v))
    gnorm_ok = [v for v in gnorm if np.isfinite(v)]
    if gnorm:
        line = f"- global grad norm: {len(gnorm)} records"
        if gnorm_ok:
            line += (
                f" · last finite {_fmt(gnorm_ok[-1])} · max {_fmt(max(gnorm_ok))}"
                f" · trend `{_trend(gnorm_ok)}`"
            )
        if gnorm_bad:
            line += f" · {gnorm_bad} NONFINITE record(s)"
        lines.append(line)
        lines.append("")
    subtrees = sorted(
        {k[len("num/grad_norm/"):] for k in num_keys if k.startswith("num/grad_norm/")}
    )
    if subtrees:
        lines.append("| subtree | grad_norm (last) | param_norm (last) | update_ratio (last) | ratio trend |")
        lines.append("|---|---|---|---|---|")
        for sub in subtrees:
            ratios = [
                float(r[f"num/update_ratio/{sub}"])
                for r in scalars
                if f"num/update_ratio/{sub}" in r
                and np.isfinite(float(r[f"num/update_ratio/{sub}"]))
            ]
            last = {
                col: next(
                    (r[f"num/{col}/{sub}"] for r in reversed(scalars) if f"num/{col}/{sub}" in r),
                    None,
                )
                for col in ("grad_norm", "param_norm", "update_ratio")
            }
            lines.append(
                f"| {sub} | {_fmt(last['grad_norm'], 4)} | {_fmt(last['param_norm'], 2)} "
                f"| {_fmt(last['update_ratio'], 6)} | `{_trend(ratios)}` |"
            )
        lines.append("")
    classes = sorted(
        {k[len("num/quant_err_rms/"):] for k in num_keys if k.startswith("num/quant_err_rms/")}
    )
    if classes:
        version = next(
            (r["num/quant_weight_version"] for r in reversed(scalars) if "num/quant_weight_version" in r),
            None,
        )
        lines.append(
            f"### Quantization error (last handoff, weight version {_fmt(version, 0)})"
        )
        lines.append("")
        lines.append("| kernel class | max_abs_err | rms_err | snr_db |")
        lines.append("|---|---|---|---|")
        for cls in classes:
            row = {
                col: next(
                    (r[f"num/{col}/{cls}"] for r in reversed(scalars) if f"num/{col}/{cls}" in r),
                    None,
                )
                for col in ("quant_err_max", "quant_err_rms", "quant_snr_db")
            }
            lines.append(
                f"| {cls} | {_fmt(row['quant_err_max'], 6)} "
                f"| {_fmt(row['quant_err_rms'], 6)} | {_fmt(row['quant_snr_db'], 1)} |"
            )
        lines.append("")
    if numerics_bundles:
        lines.append("### NaN provenance")
        lines.append("")
        for name, payload in numerics_bundles:
            census = payload.get("grad_census", {}) or {}
            bisect = payload.get("forward_bisect", {}) or {}
            leaves = census.get("nonfinite_leaves", []) or []
            first = bisect.get("first_nonfinite")
            verdict = f"first nonfinite at `{first}`" if first else "forward clean"
            if bisect.get("injected"):
                verdict += f" (drill injection: {bisect['injected']})"
            head = " · ".join(leaf.get("path", "?") for leaf in leaves[:3])
            lines.append(
                f"- `incidents/{name}/numerics.json`: "
                f"{census.get('total_nonfinite_leaves', 0)} nonfinite grad leaves"
                + (f" ({head}{' …' if len(leaves) > 3 else ''})" if leaves else "")
                + f" · {verdict}"
            )
        lines.append("")
    return lines


# ----------------------------------------------------------------- report


def build_report(checkpoint_dir: str) -> str:
    checkpoint_dir = os.path.abspath(checkpoint_dir)
    metrics = _load_jsonl(os.path.join(checkpoint_dir, "metrics.jsonl"))
    # Fleet-aware span load: merges spans.host<k>.jsonl lanes (clock-aligned,
    # host-prefixed tids) when graftfleet ran; falls back to the plain
    # spans.jsonl events unchanged otherwise.
    from trlx_tpu_torch.observability.spans import read_fleet_spans

    spans = read_fleet_spans(checkpoint_dir)["traceEvents"]
    scalars = _scalar_records(metrics)
    lines = [f"# Performance report — `{checkpoint_dir}`", ""]

    # --- run summary ------------------------------------------------------
    steps = [r["step"] for r in scalars if isinstance(r.get("step"), (int, float))]
    hosts = sorted({e.get("pid", 0) for e in spans}) if spans else []
    lines += ["## Run summary", ""]
    lines.append(f"- scalar records: {len(scalars)}" + (f" (steps {int(min(steps))}..{int(max(steps))})" if steps else ""))
    lines.append(f"- span events: {len(spans)}" + (f" across host pid(s) {hosts}" if hosts else ""))
    times = [r["t"] for r in scalars if isinstance(r.get("t"), (int, float))]
    if len(times) >= 2:
        lines.append(f"- metrics wall span: {times[-1] - times[0]:.1f}s")
    lines.append("")

    # --- phase breakdown per window --------------------------------------
    windows = [r for r in scalars if "time/window_wall_s" in r]
    lines += ["## Phase breakdown (per window)", ""]
    if windows:
        lines.append("| step | rollout_s | score_s | train_s | wall_s | overlap | tokens/s |")
        lines.append("|---|---|---|---|---|---|---|")
        for r in windows[-12:]:
            lines.append(
                "| {} | {} | {} | {} | {} | {} | {} |".format(
                    _fmt(r.get("step"), 0),
                    _fmt(r.get("time/rollout_s")),
                    _fmt(r.get("time/score_s")),
                    _fmt(r.get("time/train_s")),
                    _fmt(r.get("time/window_wall_s")),
                    _fmt(r.get("time/overlap_fraction"), 2),
                    _fmt(r.get("train_tokens_per_s"), 0),
                )
            )
        if len(windows) > 12:
            lines.append(f"\n(last 12 of {len(windows)} windows)")
    else:
        lines.append("No phase windows recorded (serial single-batch run, or PhaseTimer off).")
    lines.append("")

    # --- MFU trend --------------------------------------------------------
    lines += ["## MFU / FLOP throughput (counted FLOPs)", ""]
    mfu = [(r.get("step"), r["obs/train_mfu_pct"]) for r in scalars if "obs/train_mfu_pct" in r]
    tfl = [r["obs/train_tflops_per_chip"] for r in scalars if "obs/train_tflops_per_chip" in r]
    if mfu:
        values = [v for _, v in mfu]
        lines.append(
            f"- train MFU: last {_fmt(values[-1], 2)}% · mean {_fmt(float(np.mean(values)), 2)}% "
            f"· max {_fmt(max(values), 2)}% over {len(values)} windows"
        )
        lines.append(f"- trend: `{_trend(values)}`")
    elif tfl:
        lines.append(
            f"- train TFLOP/s per chip: last {_fmt(tfl[-1], 2)} · mean {_fmt(float(np.mean(tfl)), 2)} "
            "(peak FLOP/s unknown — set TRLX_TPU_PEAK_TFLOPS for an MFU %)"
        )
    else:
        lines.append("No FLOP gauges recorded (train.device_telemetry off).")
    lines.append("")

    # --- staleness --------------------------------------------------------
    lines += ["## Staleness", ""]
    stale = [r for r in scalars if "staleness/mean" in r]
    hists = [r for r in metrics if r.get("histogram") == "staleness"]
    if stale:
        means = [r["staleness/mean"] for r in stale]
        maxes = [r.get("staleness/max", 0.0) for r in stale]
        lines.append(
            f"- per-batch staleness: mean {_fmt(float(np.mean(means)), 3)} · "
            f"max {_fmt(float(np.max(maxes)), 1)} over {len(stale)} batches"
        )
    if hists:
        last = hists[-1]
        lines.append(
            "- last histogram: " + " · ".join(
                f"{k} {_fmt(last.get(k))}" for k in ("p5", "p50", "p95", "max") if k in last
            )
        )
    if not stale and not hists:
        lines.append("No staleness records (serial on-policy run).")
    lines.append("")

    # --- kernel routing ---------------------------------------------------
    lines += ["## Kernel routing", ""]
    routed = [r for r in scalars if "obs/fused_logprob_active" in r]
    if routed:
        last = routed[-1]
        lines.append("| gauge | value |")
        lines.append("|---|---|")
        for key in sorted(k for k in last if k.startswith("obs/") and ("active" in k or "fallback" in k)):
            lines.append(f"| {key} | {_fmt(last[key], 0)} |")
        fallbacks = [k for k in last if k.endswith("_fallback") and last[k]]
        if fallbacks:
            lines.append("")
            lines.append(f"**WARNING: kernel fallback gauges set: {fallbacks}**")
    else:
        lines.append("No routing gauges recorded.")
    programs_path = os.path.join(checkpoint_dir, "programs.json")
    if os.path.exists(programs_path):
        try:
            with open(programs_path) as f:
                programs = json.load(f)
        except (OSError, ValueError):
            programs = {}
        if programs:
            lines += ["", "### Monitored programs", "", "| program | phase | dispatches | GFLOPs | peak MiB added |", "|---|---|---|---|---|"]
            for name, prog in sorted(programs.items()):
                variants = prog.get("variants", [])
                flops = max((v.get("flops") or 0.0 for v in variants), default=0.0)
                temp = max((v.get("peak_bytes_delta") or 0 for v in variants), default=0)
                lines.append(
                    f"| {name} | {prog.get('phase')} | {prog.get('dispatches')} "
                    f"| {_fmt(flops / 1e9, 2)} | {_fmt(temp / 2**20, 1)} |"
                )
    lines.append("")

    # --- span lanes -------------------------------------------------------
    lines += ["## Span lanes", ""]
    if spans:
        lanes = _lane_summary(spans)
        lines.append("| pid | thread | events | busy_s | top span |")
        lines.append("|---|---|---|---|---|")
        for lane in lanes:
            lines.append(
                f"| {lane['pid']} | {lane['thread']} | {lane['events']} "
                f"| {_fmt(lane['busy_s'], 2)} | {lane['top_span']} |"
            )
        overlap = _overlap_seconds(spans, "trlx-rollout-producer", "MainThread")
        if overlap > 0:
            lines.append("")
            lines.append(f"- producer/train overlap: {_fmt(overlap, 2)}s of wall where both lanes were busy")
        lines.append("")
        lines.append("Load the raw lanes in Perfetto (https://ui.perfetto.dev): open `spans.jsonl` directly,")
        lines.append("or `--trace-out trace.json` for chrome://tracing.")
    else:
        lines.append("No spans recorded (train.trace_spans off — set it or TRLX_TPU_SPANS=1).")
    lines.append("")

    # --- graftscope: device-time attribution & time sinks -----------------
    lines += _graftscope_section(checkpoint_dir)

    # --- graftfleet: cross-host federation --------------------------------
    lines += _fleet_section(checkpoint_dir)

    # --- graftnum: numerics observatory -----------------------------------
    lines += _numerics_section(checkpoint_dir, scalars)

    # --- training health --------------------------------------------------
    incidents_dir = os.path.join(checkpoint_dir, "incidents")
    bundles = sorted(os.listdir(incidents_dir)) if os.path.isdir(incidents_dir) else []
    lines += ["## Training health", ""]
    state_names = {0: "OK", 1: "WARN", 2: "CRIT"}
    state_keys = sorted(
        {k for r in scalars for k in r if k.startswith("health/") and k.endswith("_state")}
    )
    if state_keys:
        lines.append("| detector | last | worst | records | trend (0=OK 1=WARN 2=CRIT) |")
        lines.append("|---|---|---|---|---|")
        for key in state_keys:
            series = [float(r[key]) for r in scalars if key in r]
            detector = key[len("health/") : -len("_state")]
            lines.append(
                "| {} | {} | {} | {} | `{}` |".format(
                    detector,
                    state_names.get(int(series[-1]), "?"),
                    state_names.get(int(max(series)), "?"),
                    len(series),
                    _trend(series),
                )
            )
        changes = [r["health/state_changes_total"] for r in scalars if "health/state_changes_total" in r]
        if changes:
            lines.append("")
            lines.append(f"- state transitions: {int(changes[-1])} total")
        # Cross-links: incident bundles this monitor escalated (reason
        # health_<detector>) — the full bundle table is in ## Incidents.
        health_bundles = []
        for name in bundles:
            try:
                with open(os.path.join(incidents_dir, name, "incident.json")) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                continue
            if str(manifest.get("reason", "")).startswith("health_"):
                health_bundles.append((name, manifest.get("reason")))
        if health_bundles:
            lines.append(
                "- escalated incidents: "
                + " · ".join(f"{reason} -> `incidents/{name}/`" for name, reason in health_bundles)
            )
        hists = [r for r in metrics if r.get("histogram") == "health/lineage_staleness"]
        if hists:
            last = hists[-1]
            lines.append(
                "- lineage staleness (last window): " + " · ".join(
                    f"{k} {_fmt(last.get(k))}"
                    for k in ("count", "p5", "p50", "p95", "max")
                    if k in last
                )
            )
        lineage_path = os.path.join(checkpoint_dir, "lineage.jsonl")
        if os.path.exists(lineage_path):
            records = _load_jsonl(lineage_path)
            if records:
                stale_vals = [r.get("staleness", 0.0) for r in records]
                lines.append(
                    f"- lineage records: {len(records)} chunks · staleness mean "
                    f"{_fmt(float(np.mean(stale_vals)))} max {_fmt(float(np.max(stale_vals)), 1)} "
                    "(`lineage.jsonl`)"
                )
    else:
        lines.append("No health records (train.health_monitor off — set it or TRLX_TPU_HEALTH=1).")
    lines.append("")

    # --- incidents --------------------------------------------------------
    lines += ["## Incidents", ""]
    if bundles:
        lines.append("| step | reason | sections | bundle |")
        lines.append("|---|---|---|---|")
        for name in bundles:
            manifest_path = os.path.join(incidents_dir, name, "incident.json")
            reason, sections = "?", "?"
            try:
                with open(manifest_path) as f:
                    manifest = json.load(f)
                reason = manifest.get("reason", "?")
                sections = ",".join(k for k, v in manifest.get("sections", {}).items() if v == "ok")
            except (OSError, ValueError):
                pass
            lines.append(f"| {name} | {reason} | {sections} | `incidents/{name}/` |")
    else:
        lines.append("None.")
    lines.append("")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m trlx_tpu_torch.observability.report",
        description="Render a markdown performance report from a run's checkpoint dir.",
    )
    parser.add_argument("checkpoint_dir", help="directory holding metrics.jsonl / spans.jsonl")
    parser.add_argument("-o", "--out", default=None, help="write the report here (default: stdout)")
    parser.add_argument(
        "--trace-out",
        default=None,
        help="also write spans.jsonl as a {'traceEvents': [...]} JSON for chrome://tracing",
    )
    args = parser.parse_args(argv)

    report = build_report(args.checkpoint_dir)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report)
        print(f"wrote {args.out}")
    else:
        print(report)

    if args.trace_out:
        # Fleet-aware: merges spans.host<k>.jsonl into clock-aligned per-host
        # lanes when graftfleet ran; identical to the plain spans.jsonl dump
        # otherwise.
        from trlx_tpu_torch.observability.spans import read_fleet_spans

        spans = read_fleet_spans(os.path.abspath(args.checkpoint_dir))["traceEvents"]
        with open(args.trace_out, "w") as f:
            json.dump({"traceEvents": spans}, f)
        print(f"wrote {args.trace_out} ({len(spans)} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
