"""One run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``: its kind (``train``),
configuration (``benchmark/configs/<config>.json``), traffic mix
(``benchmark/traffic/<mix>.json``), chips, the driver's settings and the
limits of its comparison. The metrics a run prints are the entries of
``BENCHMARK.json`` that belong to the cell (its ``end_to_end`` metrics
without ``--trace``, its ``per_layer`` metrics with it); each is read by
``benchmark/metrics/<name>.py``, and one that finds nothing to read is left
out of the line.

The last lines on standard error, and the last key of the result line, give
each number compared beside its limit. The last line on standard output is
the result: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
and, traced, ``breakdown``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "vibertgrid_tpu")


@dataclasses.dataclass
class Context:
    name: str
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    probe: object
    t0: float
    control: int = 0
    faults: object = None
    notes: dict = dataclasses.field(default_factory=dict)
    shapes: dict = dataclasses.field(default_factory=dict)


def _load(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.exists(path):
        raise SystemExit(f"no {kind[:-1]} {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def benchmark_entries(cell: str) -> tuple[list, list]:
    """The cell's end-to-end and per-layer metrics from ``BENCHMARK.json``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]
    return e2e, layer


def check_encoder(config: dict, config_path: str) -> None:
    """Fail before set-up unless the configuration's ``model`` names its text
    encoder and window, and the encoder has its reference and its counts
    (``benchmark/reference/encoders/<name>.py``,
    ``benchmark/harness/encoders/<name>.py``)."""
    model = config["model"]
    for key in ("text_encoder", "window_tokens"):
        if key not in model:
            raise SystemExit(f"{config_path}: model.{key} is missing")
    window = model["window_tokens"]
    if not isinstance(window, int) or isinstance(window, bool) or window < 1:
        raise SystemExit(f"{config_path}: model.window_tokens {window!r} is not a positive "
                         "whole number")
    name = model["text_encoder"]
    if not isinstance(name, str) or not name.isidentifier():
        raise SystemExit(f"{config_path}: model.text_encoder {name!r} is not a module name")
    for part in ("reference", "harness"):
        module = f"benchmark.{part}.encoders.{name}"
        try:
            importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
            raise SystemExit(f"no text encoder {name!r}: benchmark/{part}/encoders/{name}.py "
                             "is missing") from None


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def apply_overrides(cell: dict, config: dict, mix: dict, overrides: dict | None):
    """Small sizes for the CPU tests: each key of ``overrides`` (``cell``,
    ``hyp``, ``model``, ``mix``) updates that part."""
    for key, target in (("cell", cell), ("hyp", config["hyp"]), ("model", config["model"]),
                        ("mix", mix)):
        target.update((overrides or {}).get(key, {}))


def device_info(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    limit = ""
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "power_limit": limit}


def compared(ctx, numbers: dict) -> list:
    """The numbers the cell's ``limits`` name, each beside its limit; the
    others go to the result's notes."""
    limits = ctx.cell["limits"]
    ctx.notes.update({k: v for k, v in numbers.items() if k not in limits})
    return [(name, numbers[name], limit) for name, limit in limits.items()]


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e12


def run(argv=None, *, t0: float | None = None, device: str = "cuda",
        overrides: dict | None = None, faults=None) -> int:
    """A run; returns the exit code. ``device``, ``overrides`` and ``faults``
    (a callable given the context and the program's objects, which breaks
    them) are for the CPU tests only."""
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="1: put the reference, in fp8 (the control), in the program's place")
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import counts, probe as probe_mod

    cell = _load("workloads", args.workload)
    config = _load("configs", cell["config"])
    mix = _load("traffic", cell["traffic"])
    apply_overrides(cell, config, mix, overrides)
    check_encoder(config, f"benchmark/configs/{cell['config']}.json")
    chips = int(cell["chips"])
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s): torch.cuda.is_available() = "
                  f"{torch.cuda.is_available()}, device_count() = "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    probe = probe_mod.Probe()
    probe.model = counts.Model.of(config)
    probe.chips = chips
    ctx = Context(name=args.workload, cell=cell, config=config, mix=mix, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), device=dev, probe=probe,
                  t0=t0, control=args.control, faults=faults)
    if cell["kind"] != "train":
        raise SystemExit(f"cell {args.workload!r} is of kind {cell['kind']!r}: "
                         "the harness drives training cells")
    from benchmark.harness import train as driver

    checks = driver.run(ctx)

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"modules that no run may load are loaded: {found}", file=sys.stderr)
        return 4

    e2e, layer = benchmark_entries(args.workload)
    metrics = {}
    for m in (layer if args.trace else e2e):
        value = reader(m["name"])(probe)
        if value is not None:
            metrics[m["name"]] = {"value": _finite(float(value)), "unit": m["unit"]}
    info = device_info(dev, chips)
    info["memory_peak_bytes"] = int(probe.memory_peak_bytes)
    if args.trace and probe.trace is not None:
        info["busy_s"] = probe.trace.busy_s
        info["window_s"] = probe.trace.window_s
    correct = all(value <= limit for _, value, limit in checks)
    result = {"correct": correct, "attempted": probe.steps, "failed": 0, "metrics": metrics,
              "device": info}
    if args.trace and probe.trace is not None:
        result["breakdown"] = probe_mod.breakdown(probe.trace)
        ctx.notes["first_device_event_s"] = probe.trace.first_at_s
    result["notes"] = ctx.notes
    result["compared"] = {name: {"value": _finite(float(value)), "limit": limit}
                          for name, value, limit in checks}
    for name, value, limit in checks:
        print(f"compared {name}: {value!r} limit {limit!r}"
              f" {'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0
