"""One run of one cell: set-up, the measured window, with --trace 1 the
profiled and the split stretches, the check against the reference, and
the result line.

A run is a closed loop of fixed-length episodes, as a vectorised
environment steps: W worlds through `step_batched`, each step ending in a
synchronization (the caller waits for every observation), every world
reset at once to a fresh initial batch when an episode ends. Each initial
batch takes its worlds from a pool of layouts that set-up builds through
the program's `WorldBuilder` from offsets drawn from the cell's layout
seed, in an order drawn from the run's seed, so a reset is one device
copy a leaf and every seed steps the same work."""

import gc
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from . import cells, check, tracing
from .program import Program
from .reference.step import DECISION_BAND, Reference

FORBIDDEN = ("jax", "jaxlib", "flax", "box2d_mt_tpu")
# the seed of the pool of layouts: every run of every cell steps the same
# layouts, so the work does not change with the run's seed
LAYOUT_SEED = 20260601
# steps of warm-up: past first contact (~step 13) and the first TOI rounds
WARMUP_STEPS = 30
# the longest stretch of an episode that the check follows, and that a
# traced run profiles and splits
STRETCH_STEPS = 60


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of draws, fixed by the run's seed."""
    return random.Random(f"{seed}:{stream}").getrandbits(63)


def draw_offsets(cell, config, scene, device, layout_seed=LAYOUT_SEED) -> np.ndarray:
    """(variants, n) float64 offsets, uniform in +- the scene's OFFSET_MAX,
    drawn on the device from the layout seed."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(layout_seed, "offsets"))
    u = torch.rand((cell["variants"], scene.n_offsets(config)), generator=g,
                   dtype=torch.float64, device=device)
    return ((2.0 * u - 1.0) * scene.OFFSET_MAX).cpu().numpy()


class Tally:
    """World-steps that failed (pair or TOI overflow, a non-finite body)
    and world-steps with a color overflow, summed on the device; a step
    that took the all-asleep path (the bodies come back untouched) has
    neither and adds nothing."""

    def __init__(self, device):
        self.failed = torch.zeros((), dtype=torch.int64, device=device)
        self.color = torch.zeros((), dtype=torch.int64, device=device)

    def add(self, new, old, events) -> bool:
        if new.bodies is old.bodies:
            return True
        b = new.bodies
        finite = torch.isfinite(torch.cat([b.c.flatten(1), b.a, b.v.flatten(1), b.w], 1)).all(1)
        self.failed += ((events.pair_overflow > 0) | (events.toi_overflow > 0) | ~finite).sum()
        self.color += (events.color_overflow > 0).sum()
        return False


class Episode:
    def __init__(self, idx, s0, n):
        self.idx, self.s0, self.n, self.states, self.events = idx, s0, n, [], []


class Loop:
    """The closed loop. Each reset fills the W worlds with the pool's
    layouts, each as often as every other (W // V or one more), in an
    order drawn from the seed. While `sampling`, each episode keeps its states
    from step s0 to s0 + n (s0 drawn from the seed), and at its end a
    seeded draw makes it the one to check with chance 1/k, k the episodes
    ended so far: every ended episode is equally likely to be checked."""

    def __init__(self, timed, pool, cell, step_kw, seed, device):
        self.timed, self.pool, self.step_kw = timed, pool, step_kw
        self.worlds, self.length = cell["worlds"], cell["episode_steps"]
        self.check_n = min(STRETCH_STEPS, self.length)
        self.layouts = torch.arange(self.worlds, device=device) % cell["variants"]
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(stream_seed(seed, "resets"))
        self.rng = random.Random(stream_seed(seed, "episodes"))
        self.device = device
        self.tally = Tally(device)
        self.hooks = {}
        self.sampling = True
        self.ended = 0
        self.kept = None
        self.state = self.episode = None
        self.t = 0

    def new_episode(self):
        self.t = 0

    def _reset(self):
        idx = self.layouts[torch.randperm(self.worlds, generator=self.gen,
                                          device=self.device)]
        self.state = self.timed.gather(self.pool, idx)
        s0 = self.rng.randrange(self.length - self.check_n + 1)
        self.episode = Episode(idx, s0, self.check_n) if self.sampling else None

    def one_step(self):
        """One step, a reset first at an episode's start; the caller
        synchronizes. Returns (host syncs, whether it took the all-asleep
        path)."""
        if self.t == 0:
            self._reset()
        ep = self.episode
        keep = ep is not None and ep.s0 <= self.t < ep.s0 + ep.n
        if keep and self.t == ep.s0:
            ep.states.append(self.state)
        new, events = self.timed.step(self.state, self.step_kw, **self.hooks)
        asleep = self.tally.add(new, self.state, events)
        if keep:
            ep.states.append(new)
            ep.events.append(events)
        self.state = new
        self.t += 1
        if self.t == self.length:
            self.t = 0
            if ep is not None:
                self.ended += 1
                if self.rng.random() * self.ended < 1.0:
                    self.kept = ep
        return events.host_syncs, asleep


def measure(loop: Loop, seconds: float, sync) -> dict:
    """The window: whole episodes, to the first episode's end at or after
    `seconds`, each step timed from the end of the last to after its own
    synchronization. Whole episodes keep the mix of a cell's steps (first
    contact or settled, awake or asleep) the same whatever the window's
    length in steps; a window cut inside an episode would weigh its last
    episode's phase at random."""
    step_s, syncs, asleep = [], 0, 0
    # the collector's passes over a growing heap would land in random
    # steps: collect once, freeze what set-up made, and hold it off
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        sync()
        start = now = time.perf_counter()
        while now - start < seconds or loop.t != 0:
            t0 = now
            s, a = loop.one_step()
            sync()
            now = time.perf_counter()
            step_s.append(now - t0)
            syncs += s
            asleep += a
    finally:
        gc.enable()
        gc.unfreeze()
    return {"steps": len(step_s), "wall_s": now - start, "step_s": step_s,
            "worlds": loop.worlds, "host_syncs": syncs, "asleep_steps": asleep}


def profile_stretch(loop, n_steps, span_files, sync, kernels, on_card) -> dict:
    """`n_steps` from a fresh episode under `torch.profiler`, the phases
    marked by the spans' ranges, the kernel entries' calls recorded."""
    from torch.profiler import ProfilerActivity, profile, record_function
    recorders = {k: tracing.CallRecorder(fn) for k, fn in kernels.items()}
    loop.hooks = recorders
    loop.new_episode()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    sync()
    with tracing.Spans(span_files, sync).installed("range"), \
            profile(activities=activities) as prof:
        for _ in range(n_steps):
            with record_function(tracing.STEP):
                loop.one_step()
                sync()
    loop.hooks = {}
    summary = tracing.summarize(prof, n_steps)
    summary["calls"] = {k: r.to_host() for k, r in recorders.items()}
    return summary


def split_stretch(loop, n_steps, span_files, sync) -> dict:
    """`n_steps` from a fresh episode with every span synchronized."""
    spans = tracing.Spans(span_files, sync)
    loop.new_episode()
    sync()
    t0 = time.perf_counter()
    with spans.installed("split"):
        for _ in range(n_steps):
            loop.one_step()
            sync()
    return {"steps": n_steps, "wall_s": time.perf_counter() - t0, "spans": spans.seconds}


def run_check(ep: Episode, program_pool, reference, scene, config, offsets,
              step_kw) -> tuple:
    """The start and the kept stretch of the checked episode against the
    reference; returns (the compared numbers, what the check left out)."""
    values = {"start_gap": check.start_gap(program_pool,
                                           reference.build_pool(scene, config, offsets))}
    steps, seen = reference.follow(ep.states, ep.events, step_kw)
    values.update(steps)
    return values, seen


def card_line(device) -> dict:
    """The card's name, count and power limit (nvidia-smi)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return {"kind": torch.cuda.get_device_name(device),
            "power_limit": out[device.index or 0] if out else "not read"}


def run_cell(cell, config, metrics, seed, seconds, traced, t_start, device,
             timed=None, reference=None, log=print, chips=1) -> dict:
    """One run; returns the result object (the last line's keys and the
    compared numbers). `timed` is the system under test (the program by
    default) and `reference` the check's side (the plain reference)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    scene = cells.scene(config["scene"])
    step_kw = dict(config["step"])
    timed = timed or Program(device)
    marks = [("imports", time.perf_counter())]
    offsets = draw_offsets(cell, config, scene, device)
    pool = timed.build_pool(scene, config, offsets)
    sync()
    marks.append(("pool", time.perf_counter()))
    loop = Loop(timed, pool, cell, step_kw, seed, device)
    for _ in range(min(WARMUP_STEPS, cell["episode_steps"])):
        loop.one_step()
    sync()
    marks.append(("warm-up", time.perf_counter()))
    loop.new_episode()
    loop.ended, loop.kept = 0, None
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    window = measure(loop, seconds, sync)
    loop.sampling = False
    record = {"setup_s": setup_s, "window": window, "profile": None, "split": None}
    if traced:
        spans = cells.spans_of(metrics)
        kernels = getattr(timed, "kernels", {})
        n = min(STRETCH_STEPS, cell["episode_steps"])
        record["profile"] = profile_stretch(loop, n, spans, sync, kernels, on_card)
        record["split"] = split_stretch(loop, n, spans, sync)
    sync()
    failed, color = int(loop.tally.failed), int(loop.tally.color)
    dev = {"platform": "gpu" if on_card else device.type, "count": chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}
    if on_card:
        dev.update(card_line(device))
    if traced:
        dev["busy_s"] = record["profile"]["busy_s"]
        dev["window_s"] = record["profile"]["span_s"]
    kept = loop.kept
    loop.state = loop.episode = None        # the program's state, freed

    t_check = time.perf_counter()
    reference = reference or Reference(device)
    values, seen = run_check(kept, pool, reference, scene, config, offsets, step_kw)
    correct, compared = check.judge(values, cell["limits"])

    steps = window["steps"]
    w = window["step_s"]
    log("set-up: " + ", ".join(f"{k} {t - t0:.3f} s" for (k, t), (_, t0)
                               in zip(marks, [("start", t_start)] + marks[:-1])))
    log(f"world-steps with a color overflow: {color}; failed: {failed}")
    log(f"check: episode with {len(kept.states) - 1} steps from step {kept.s0} "
        f"checked in {time.perf_counter() - t_check:.3f} s; world-steps followed "
        f"{seen['checked']} of {seen['world_steps']} (the rest within "
        f"{DECISION_BAND} m of a collider's or the sleep rule's threshold); bodies left out "
        f"of a step for a TOI sub-step: {seen['toi_bodies']}; worlds ordered "
        f"by the reference's own coloring: {seen['order_fallback']}; least margin "
        f"{seen['least_margin']}")
    if traced:
        p, s = record["profile"], record["split"]
        log(f"profiled stretch: {p['steps']} steps, {p['span_s']:.6f} s, "
            f"{p['device_events']} device events; split stretch: {s['steps']} steps "
            f"in {s['wall_s']:.6f} s synchronized: "
            + ", ".join(f"{k} {v:.6f} s" for k, v in s["spans"].items()))
    out = {}
    for m in metrics:
        v = cells.reader(m["name"]).read(record)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": steps * loop.worlds, "failed": failed,
              "metrics": out, "device": dev}
    if traced:
        result["breakdown"] = {"device_ops": tracing.top(record["profile"]["kernels"]),
                               "idle_gaps": tracing.top(record["profile"]["idle"])}
    result["compared"] = compared
    log(f"run: {time.perf_counter() - t_start:.3f} s from the process's start")
    # the line before the result: the count and the median beside the p95
    log(f"window: {steps} steps of {loop.worlds} worlds in {window['wall_s']:.6f} s; "
        f"step median {1e3 * statistics.median(w):.6f} ms over {steps} steps; "
        f"all-asleep path {window['asleep_steps']} steps "
        f"({100.0 * window['asleep_steps'] / steps:.4f}%); host syncs "
        f"{window['host_syncs'] / steps:.6f} a step")
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(args, t_start) -> int:
    import json
    torch.set_num_threads(1)
    bench = cells.benchmark()
    entry = cells.cell_entry(bench, args.workload)
    cell = cells.cell(args.workload)
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{args.workload}.json disagrees with BENCHMARK.json")
    config = cells.config(cell["config"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    metrics = cells.metrics_of(bench, args.workload, bool(args.trace))
    result = run_cell(cell, config, metrics, args.seed, args.seconds, bool(args.trace),
                      t_start, "cuda:0", log=lambda s: print(s, flush=True),
                      chips=entry["chips"])
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
