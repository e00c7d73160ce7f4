#!/usr/bin/env python3
"""Where a cell's step goes, by the program's own spans (`b2.*`).

    python3 benchmark/tools/spans.py --workload <cell> --seed <n> --runs 2 --out FILE

Sets the cell up as a run does (the pool, the closed loop, the warm-up),
then profiles `--runs` stretches of STRETCH_STEPS steps, each from a fresh
episode, as the traced run's profiled stretch does, inside
`box2d_mt_tpu_torch.trace.collect()`. For each stretch it prints the
`by_span` table (benchmark/by_span.py: a row a span, each number a step),
the shares of b2.step's self time and of unattributed device time, the
counts (colorings, pair refreshes, TOI rounds a step, and the host reads
by span against Events.host_syncs), and one JSON line; `--out` keeps them
all.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

GRAPH_PREP = ("b2.touch", "b2.islands", "b2.coloring", "b2.prepare")
TOI = ("b2.toi", "b2.toi_round", "b2.toi_substep")


def stretch(loop, n_steps, sync, collect, on_card=True):
    """`n_steps` from a fresh episode under torch.profiler, inside
    `collect()`; returns (the profiler, the counts, Events.host_syncs
    summed, seconds)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from benchmark import tracing
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    loop.new_episode()
    sync()
    syncs = 0
    with collect() as counts, profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            with record_function(tracing.STEP):
                syncs += loop.one_step()[0]
                sync()
        seconds = time.perf_counter() - t0
    return prof, counts, syncs, seconds


def reduce(prof, counts, syncs, seconds, n):
    from benchmark import by_span, tracing
    whole = tracing.summarize(prof, n)
    c = counts.as_dict()
    rows = by_span.summarize(by_span.events(prof), c, step=tracing.STEP)
    per_step = dict(
        colorings_per_step=c["events"]["coloring.runs"] / n,
        pair_refreshes_per_step=c["events"]["pairs.refreshes"] / n,
        toi_rounds_per_step=c["events"]["toi.rounds"] / n,
        coloring_device_ms=by_span.device_ms(rows, ("b2.coloring",), n),
        graph_prep_device_ms=by_span.device_ms(rows, GRAPH_PREP, n),
        collide_device_ms=by_span.device_ms(rows, ("b2.collide", "b2.pre_solve_hook"), n),
        toi_device_ms=by_span.device_ms(rows, TOI, n))
    return {"steps": n, "seconds": seconds, "step_ms": 1e3 * seconds / n,
            "span_s": whole["span_s"], "busy_s": whole["busy_s"],
            "device_idle_pct": (100.0 * (1.0 - whole["busy_s"] / whole["span_s"])
                                if whole["span_s"] > 0 else None),
            "kernels_per_step": whole["device_events"] / n, "host_syncs": syncs,
            "reads_by_span": sum(r["reads"] for r in rows.values()),
            "counts": c, "shares": by_span.shares(rows), "per_step": per_step,
            "by_span": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if p != str(Path(__file__).parent)]
    import torch
    from benchmark import by_span, cells, harness
    from benchmark.program import Program
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from box2d_mt_tpu_torch.trace import collect
    torch.set_num_threads(1)
    device = torch.device("cuda:0")
    sync = torch.cuda.synchronize
    cell = cells.cell(args.workload)
    config = cells.config(cell["config"])
    scene = cells.scene(config["scene"])
    timed = Program(device)
    pool = timed.build_pool(scene, config,
                            harness.draw_offsets(cell, config, scene, device))
    loop = harness.Loop(timed, pool, cell, dict(config["step"]), args.seed, device)
    loop.sampling = False
    for _ in range(min(harness.WARMUP_STEPS, cell["episode_steps"])):
        loop.one_step()
    sync()
    n = min(harness.STRETCH_STEPS, cell["episode_steps"])
    records = []
    for run in range(args.runs):
        rec = reduce(*stretch(loop, n, sync, collect), n)
        records.append(rec)
        print(f"stretch {run}: {n} steps, {rec['step_ms']:.3f} ms a step, device idle "
              f"{rec['device_idle_pct']:.2f}%, {rec['kernels_per_step']:.1f} device events "
              f"a step; host reads {rec['host_syncs']} (by span {rec['reads_by_span']}); "
              f"shares {rec['shares']}; {rec['per_step']}")
        print("\n".join(by_span.table(rec["by_span"], n)), flush=True)
        print(json.dumps({k: v for k, v in rec.items() if k != "by_span"}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "seed": args.seed,
                                              "card": harness.card_line(device),
                                              "runs": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
