"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, the result line.

Everything a cell needs is found by name from `BENCHMARK.json`: the
cell's configuration file, its traffic mix `traffic/<name>.json` (whose
"entry" names the module `entries/<entry>.py`), its correctness limits
`limits/<cell>.json`, and a reader `metrics/<name>.py` for each metric
(or `metrics/<base>.py` for `<base>.<part>`, called with the part).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "kytpu"}


@dataclass
class Run:
    """What the readers read."""
    entry: str
    lanes: int                     # rays of one call
    setup_s: float
    calls: list = field(default_factory=list)   # (start, returned, result)
    window_s: float = 0.0
    peak_bytes: int = 0
    profile: object = None         # devtrace.Profile of the traced window
    work: dict | None = None       # least work of one call


def spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict, kind: str) -> list:
    """The cell's end-to-end ("end_to_end") or per-layer metrics."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])}
    out = []
    for m in bench[kind]:
        listed = m.get("workloads")
        if kind == "end_to_end":
            ok = m["name"] in e2e
        else:
            ok = (cell["name"] in listed if listed is not None
                  else m["moves"] in e2e)
        if ok:
            out.append(m)
    return out


def reader(name: str):
    """(read function, part) for metric `name`."""
    tries = [(name, None)]
    if "." in name:
        tries.append(tuple(name.split(".", 1)))
    for mod, part in tries:
        path = HERE / "metrics" / f"{mod}.py"
        if path.exists():
            sp = importlib.util.spec_from_file_location(
                f"perfbench.metrics._{mod.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(sp)
            sp.loader.exec_module(module)
            return module.read, part
    raise SystemExit(f"no reader metrics/{name}.py for metric {name!r}")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def device_info(device, count: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": int(peak)}


def load_cell(root: Path, workload: str, bench=None, sizes=None):
    """(cell, configuration, traffic mix, limits, entry module) of a
    workload, found by name. Tests pass `sizes`, which overrides the
    configuration's "args" and the mix's keys, and may pass `bench` in
    place of root's BENCHMARK.json."""
    bench = bench or spec(root)
    cell = cell_of(bench, workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    if sizes:
        config["args"].update(sizes.get("args", {}))
        traffic.update(sizes.get("traffic", {}))
    entry = importlib.import_module(f"perfbench.entries.{traffic['entry']}")
    return cell, config, traffic, limits, entry


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device="cuda", sizes=None,
             bench=None):
    """One run -> (result dict without `compared`, compared, Run); `sizes`
    and `bench` as `load_cell` takes them."""
    bench = bench or spec(root)
    cell, config, traffic, limits, entry = load_cell(root, workload, bench,
                                                      sizes)
    on_card = torch.device(device).type == "cuda"

    job = entry.Workload(config, traffic, seed, device)
    run = Run(entry=job.entry, lanes=job.lanes,
              setup_s=time.perf_counter() - t_start)
    # the measured window: calls back to back, each to its result on the
    # host, until `seconds` have passed; the window closes with the last
    w0 = time.perf_counter()
    now = w0
    while now - w0 < seconds:
        t0 = time.perf_counter()
        handle = job.call()
        t1 = time.perf_counter()
        job.result(handle)
        now = time.perf_counter()
        run.calls.append((t0, t1, now))
    run.window_s = now - w0
    if trace:
        from perfbench.devtrace import profile_calls
        n = max(3, int(traffic["trace_seconds"] * len(run.calls)
                       / run.window_s))
        run.profile = profile_calls(
            lambda _k: job.result(job.call()), n)
    if on_card:
        torch.cuda.synchronize()
        run.peak_bytes = torch.cuda.max_memory_allocated()
    job.free()
    if on_card:
        torch.cuda.empty_cache()
    numbers, failed, run.work = job.check(limits)
    compared = {k: {"value": v, "limit": limits[k]} for k, v in
                numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, cell, kind):
        read, part = reader(m["name"])
        value = read(run, part)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(run.calls),
              "failed": int(failed), "metrics": metrics,
              "device": (device_info(device, cell["chips"], run.peak_bytes)
                         if on_card else {"platform": "cpu", "kind": "cpu",
                                          "count": 1,
                                          "memory_peak_bytes": 0})}
    if trace:
        p = run.profile
        result["device"].update(busy_s=p.busy_s, window_s=p.window_s)
        result["breakdown"] = {"device_ops": p.device_ops,
                               "idle_gaps": p.idle_gaps}
    return result, compared, run


def main(args, t_start: float) -> int:
    root = Path.cwd()
    if not (root / "BENCHMARK.json").exists():
        print("BENCHMARK.json is not in the working directory",
              file=sys.stderr)
        return 2
    cell = cell_of(spec(root), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell[
            "chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared, _ = run_cell(root, args.workload, args.seed,
                                   args.seconds, bool(args.trace), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the port and the benchmark import no "
              "JAX and nothing of the JAX package", file=sys.stderr)
        return 3
    for k, c in compared.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(result_line(result, compared), flush=True)
    return 0


def result_line(result: dict, compared: dict) -> str:
    """The last line of a run: the result, the numbers compared last."""
    return json.dumps(dict(result, compared=compared))
