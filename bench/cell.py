"""Finding a cell's pieces by name: the manifest (``BENCHMARK.json``), the
configuration's file and module, the traffic file, the limits of the
comparison that decides ``correct`` and the per-layer metrics' readers."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, tag: str):
    """The Python file ``path`` as a module named ``bench_<tag>_<stem>``
    (a file's name may hold dots and dashes, as the names it carries do)."""
    name = "bench_" + tag + "_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""
    name: str
    chips: int
    config: dict              # configs/<config>.json
    model: object             # configs/<config>.py
    traffic: dict             # traffic/<traffic>.json
    limits: dict              # limits/<cell>.json
    end_to_end: List[dict]    # the manifest's metrics that this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    m = manifest(root)
    (w,) = [w for w in m["workloads"] if w["name"] == name] or [None]
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    (c,) = [c for c in m["configs"] if c["name"] == w["config"]]
    cfg = json.loads((root / c["file"]).read_text())
    bench = root / "bench"
    return Cell(
        name=name, chips=w["chips"], config=cfg,
        model=load_module((root / c["file"]).with_suffix(".py"), "config"),
        traffic=json.loads(
            (bench / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=[e for e in m["end_to_end"] if _reports(e, name)],
        per_layer=[p for p in m["per_layer"] if _reports(p, name)])


def readers(cell: Cell, root: Path = ROOT) -> Dict[str, object]:
    """Each per-layer metric's reader, ``metrics/<name>.py``."""
    return {p["name"]: load_module(root / "bench" / "metrics"
                                   / f"{p['name']}.py", "metric")
            for p in cell.per_layer}
