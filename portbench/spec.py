"""The manifest, ``BENCHMARK.json`` at the root of the checkout, and what a
cell is made of, found by name: its configuration (the file the manifest
names), its traffic mix (``traffic/<traffic>.json``), the driver of the
mix's kind (``drivers/<kind>.py``) and the reader of each of its metrics
(``metrics/<metric>.py``)."""

from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, bench: dict | None = None, root: Path = ROOT,
         here: Path = HERE) -> Cell:
    """The cell ``name`` of the manifest, its files read."""
    bench = manifest(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=name, chips=w["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                mix=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def _load(kind: str, name: str, path: Path):
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<metric>.py``."""
    return _load("metric", metric, here / "metrics" / f"{metric}.py").read


@functools.lru_cache(maxsize=None)
def _driver(path: Path):
    return _load("driver", path.stem, path).Driver


def driver(kind: str, here: Path = HERE):
    """The ``Driver`` class of ``drivers/<kind>.py``, loaded once a file."""
    path = here / "drivers" / f"{kind}.py"
    if not path.is_file():
        raise KeyError(f"no driver {kind!r}: {path} is missing")
    return _driver(path.resolve())
