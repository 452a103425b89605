"""Run one cell of the benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A fresh process per run: it builds the cell's configuration on the card
from the seed (weights, frames), warms the pipeline up, streams the frames
through ``OVOSemMap.run`` for about ``--seconds``, judges what the timed
path produced against the plain reference, and prints one JSON line last.
With ``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` and the line holds
its per-layer metrics and the device breakdown. A cell is found by name in
``BENCHMARK.json``; its configuration, traffic, limits and per-layer
readers are files under ``portbench/`` named after them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

from .readers import percentile  # noqa: E402
from .spec import ROOT, load_cell, merged  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ovo_tpu")
# a traced window holds at most this many seconds of the cell's pace: the
# per-layer metrics are per keyframe or shares, and reading a longer
# window's trace (millions of events) would not end within a run's time
TRACE_SECONDS = 20.0


def _cache_env() -> None:
    """Fixed cache directories inside the checkout, so that only a cell's
    first run in a checkout builds (nvcc's libraries already live in
    ``build/``, ``ops/cuda_build``)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class HostLoad:
    """What the host did to the process over a window: garbage-collection
    pauses, the process's CPU time and the machine's stolen CPU time (from
    the interpreter and ``/proc/stat``)."""

    def __init__(self):
        self.pauses = []
        self._t = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append(time.perf_counter() - self._t)

    @staticmethod
    def _steal_s() -> float:
        try:
            with open("/proc/stat") as f:
                cpu = f.readline().split()
            return int(cpu[8]) / os.sysconf("SC_CLK_TCK")
        except (OSError, IndexError, ValueError):
            return float("nan")

    def __enter__(self):
        self._steal = self._steal_s()
        self._cpu = time.process_time()
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        self.facts = {
            "host_gc_pauses": len(self.pauses),
            "host_gc_pause_s": sum(self.pauses),
            "host_gc_pause_max_s": max(self.pauses, default=0.0),
            "host_steal_s": self._steal_s() - self._steal,
            "host_process_cpu_s": time.process_time() - self._cpu}


# ---------------------------------------------------------------------------

class Cell:
    """One cell's program, frames, weights and probe on one device."""

    def __init__(self, cfg, traffic, seed: int, device, out_dir: Path):
        import torch

        from ovo_tpu_torch.mapping.pipeline import OVOSemMap

        from . import check, scene
        from .parts import sam2_amg, towers

        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        self.pcfg = merged(cfg["program"], traffic["program"])
        semantic = self.pcfg["semantic"]
        self.sam = semantic["sam"]
        self.n_masks = int(semantic["capacity"]["n_masks"])
        self.dataset = scene.ReplayDataset(traffic, seed, device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.weights = {"sam": sam2_amg.make_weights(self.sam, gen),
                        **towers.make_weights(cfg, gen)}
        source = sam2_amg.build_program(self.sam, self.weights["sam"],
                                        self.n_masks, device)
        embedder = towers.build_program(cfg, self.weights, device)
        self.sem_map = OVOSemMap(json.loads(json.dumps(self.pcfg)), out_dir,
                                 mask_source=source, embedder=embedder,
                                 dataset=self.dataset, device=device)
        self.clock = check.Clock(device)
        self.probe = check.Probe(self.sem_map, self.clock,
                                 check.HostCopies(device))
        self.seg_every = self.sem_map.segment_every
        self.map_every = self.sem_map.map_every
        self.batch = int(self.sam.get("batch", 1))

    def stream(self, first: int, last: int) -> None:
        """``OVOSemMap.run`` over frame ids [first, last)."""
        self.dataset.n_frames = last
        self.sem_map.first_frame = first
        self.sem_map.run()


def window_keyframes(seconds: float, pace: float, batch: int) -> int:
    """Keyframes in a window: ``seconds`` at ``pace`` keyframes a second,
    in whole micro-batches, at least one."""
    return max(batch, int(round(seconds * pace / batch)) * batch)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cell_metrics(bench, cell_name: str, kind: str):
    """The names of the ``kind`` ("end_to_end" or "per_layer") metrics
    that cell ``cell_name`` reports."""
    return [m["name"] for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def run_cell(bench, cell_name, cfg, traffic, limits, seed: int,
             seconds: float, trace: bool, device, control: bool = False,
             log=print):
    """Set up, warm up, time one window, judge it. Returns the result dict
    (its ``device`` record without the card's name), after printing the
    cell's state through ``log``."""
    import torch

    from . import judge, timeline

    facts = {}
    tmp = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get(
        "TMPDIR")))
    try:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            from ovo_tpu_torch.ops import cuda_build

            # the libraries the configuration's cells launch, built side by
            # side; one the port no longer has is skipped, one not listed
            # builds on its first launch in the warm-up
            cuda_build.build_all([k for k in cfg.get("prebuild_kernels", [])
                                  if k in cuda_build.KERNELS])
        c = Cell(cfg, traffic, seed, device, tmp / "run")
        probe, clock = c.probe, c.clock
        # the run's first keyframe: its masks are judged with the start of
        # the mapping (``check.ref_start``)
        probe.samples = {0}

        # warm-up: the same object to steady state (every shape the window
        # uses); its rate is printed beside the window's
        warm_kf = int(traffic["warmup_keyframes"])
        warm_frames = warm_kf * c.seg_every
        sync(device)
        w0 = clock.mark()
        c.stream(0, warm_frames)
        sync(device)
        done = sorted(probe.kf_done.items())
        first_done = done[min(c.batch, len(done)) - 1][1]
        warm_s = (clock.device_s(w0, probe.end_mark)
                  - clock.device_s(w0, first_done))
        # a fixed amount of work: the keyframes the cell's pace (its rate
        # measured when the cell was defined) gets through in ``seconds``
        n_kf = window_keyframes(min(seconds, TRACE_SECONDS) if trace
                                else seconds, float(traffic["pace_kf_per_s"]),
                                c.batch)
        first, last = warm_frames, warm_frames + n_kf * c.seg_every
        facts.update(warmup_keyframes=len(probe.segmented),
                     warmup_kf_per_s=len(probe.segmented) / max(warm_s, 1e-6),
                     window_keyframes_planned=n_kf)

        # the stages judged afterwards, drawn from the seed
        rng = random.Random(seed)
        kfs = list(range(first, last, c.seg_every))
        probe.samples = set(rng.sample(kfs, min(int(traffic["samples"]),
                                                len(kfs))))
        maps = [f for f in range(first, last, c.map_every)
                if f % c.seg_every]
        probe.map_samples = set(rng.sample(maps, 1)) if maps else set()
        facts.update(sampled_keyframes=sorted(probe.samples),
                     sampled_map_frames=sorted(probe.map_samples))
        probe.reserve(len(probe.samples),
                      c.dataset.segment_image(0).shape[:2], c.n_masks)
        n_warm = len(probe.segmented)
        n_warm_spans = len(probe.spans)

        if device.type == "cuda":
            from ovo_tpu_torch.ops import cuda_build

            cuda_build.reset_launch_counts()
        gc.collect()
        sync(device)
        setup_s = time.perf_counter() - T_START
        prof = timeline.start_profiler(device) if trace else None
        caught = None
        if trace and device.type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught, \
                HostLoad() as host:
            warnings.simplefilter("always")
            anchor_ns = time.time_ns()
            m0 = clock.mark()
            probe.end_mark = None
            c.stream(first, last)
        if trace and device.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
        sync(device)
        wall_end = time.perf_counter()
        trace_path = None
        if prof is not None:
            prof.stop()
            trace_path = tmp / "trace.json"
            prof.export_chrome_trace(str(trace_path))
            del prof

        # the window's numbers
        window_s = clock.device_s(m0, probe.end_mark) - clock.marks[m0][0]
        segmented = probe.segmented[n_warm:]
        n = len(segmented)
        lat = [clock.device_s(m0, probe.kf_done[f]) - probe.kf_take[f]
               for f in segmented if f in probe.kf_done]
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        st = c.sem_map.slam_backbone.get_map()
        ovo = c.sem_map.ovo
        valid = [int(v) for v in probe.valid_counts[n_warm:]]
        facts.update(
            setup_s=setup_s, window_keyframes=n, window_frames=last - first,
            window_s=window_s, wall_s=wall_end - clock.marks[m0][0],
            unassociated_keyframes=n - len(lat),
            map_live_points=int(st.count), map_capacity=st.capacity,
            instances=int(ovo.store.next_id),
            instance_capacity=ovo.store.capacity,
            valid_masks_per_keyframe_min=min(valid, default=0),
            valid_masks_per_keyframe_mean=sum(valid) / max(len(valid), 1),
            valid_masks_per_keyframe_max=max(valid, default=0),
            dropped_masks=ovo.n_dropped_masks_total(),
            memory_peak_bytes=peak, **host.facts)
        for k, v in facts.items():
            log(f"[portbench] {k}: {v}")

        metrics = {}
        if not trace:
            e2e = {"kf_per_s": (n / window_s, "kf/s"),
                   "crop_kf_per_s": (n / window_s, "kf/s"),
                   "kf_latency_p95_ms": (1e3 * percentile(lat, 95) if lat
                                         else None, "ms"),
                   "peak_mem_gib": (peak / 2 ** 30, "GiB"),
                   "setup_s": (setup_s, "s")}
            wanted = cell_metrics(bench, cell_name, "end_to_end")
            metrics = {k: {"value": v, "unit": u} for k, (v, u) in e2e.items()
                       if v is not None and k in wanted}
            breakdown = None
            device_extra = {}
        else:
            readings = timeline.readings(
                device=device, trace_path=trace_path, anchor_ns=anchor_ns,
                spans=probe.spans[n_warm_spans:], n_kf=n, window_s=window_s,
                wall_s=wall_end - clock.marks[m0][0], latencies_s=lat,
                syncs=sum("synchroniz" in str(w.message) for w in caught),
                cfg=cfg, traffic=traffic, batch=c.batch,
                image_hw=c.dataset.segment_image(0).shape[:2])
            metrics = timeline.per_layer(
                readings, cell_metrics(bench, cell_name, "per_layer"))
            breakdown = readings.breakdown
            device_extra = {"busy_s": readings.busy_s,
                            "window_s": readings.trace_window_s}
            for k, v in readings.facts.items():
                log(f"[portbench] {k}: {v}")

        # judge what the window produced, once its state is read and freed
        judged = probe.samples | {probe.start_fid}
        captured = {fid: probe.cap.get(fid) for fid in
                    sorted(judged | probe.map_samples)}
        descs = {f: ovo.kf_descriptors.get(i)
                 for i, f in enumerate(ovo.frame_ids) if f in judged}
        dataset, weights = c.dataset, c.weights
        del c, probe, ovo, st
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        numbers, control_numbers = judge.judge(
            cfg, traffic, weights, dataset, captured, descs, device,
            control=control)
        # the numbers the cell compares are those its limits file names;
        # the others are printed beside them
        for k, v in numbers.items():
            if k not in limits:
                log(f"[portbench] not compared: {k} {v!r}")
        checks = held(numbers, limits)
        result = {"correct": passes(checks), "attempted": n,
                  "failed": n - len(lat), "metrics": metrics,
                  "device": {"memory_peak_bytes": peak, **device_extra}}
        if breakdown is not None:
            result["breakdown"] = breakdown
        if control:
            # the control in the program's place, judged by the same limits
            result["control"] = control_numbers
            result["control_checks"] = held(control_numbers, limits)
            result["control_correct"] = passes(result["control_checks"])
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def held(numbers, limits):
    """Each number a cell compares beside its limit."""
    return {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}


def passes(checks) -> bool:
    return all(v["value"] <= v["limit"] for v in checks.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also read the control's numbers (calibration)")
    args = ap.parse_args(argv)
    _cache_env()
    bench, cell, cfg, traffic, limits = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"[portbench] needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(device)
    print(f"[portbench] card: {name}; nvidia-smi: {nvidia_smi()}", flush=True)
    print(f"[portbench] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    result = run_cell(bench, args.workload, cfg, traffic, limits, args.seed,
                      args.seconds, bool(args.trace), device,
                      control=bool(args.control),
                      log=lambda s: print(s, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": name, "count": 1,
                        **result["device"]}
    return emit(result)


def emit(result) -> int:
    """The checks on standard error (the control's first, where read), then
    the result as the last line of standard output."""
    for k, v in result.get("control_checks", {}).items():
        print(f"control check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    if "control_correct" in result:
        print(f"control correct {result['control_correct']}",
              file=sys.stderr, flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
