"""A cell of a new data generator (``kinds/<kind>.py``) and a new request
kind (``calls/<entry>.py``) is reached by new files and new entries in a
copy of ``BENCHMARK.json`` alone; the built-in kinds and entries resolve as
before and make the same data; a name found nowhere fails early."""
import hashlib
import json
from pathlib import Path

import pytest

from bench_port import control, entries, gen, harness, lookup

ROOT = Path(__file__).resolve().parents[2]

# A tridiagonal, diagonally dominant system, with a dataclass of its own
# under postponed annotations.
TRIDIAGONAL = '''
"""Off-diagonal U(-1, 1) entries next to the diagonal, the diagonal
2 * |off-diagonal row sum| + 1."""
from __future__ import annotations

import dataclasses

import torch

from bench_port import gen


@dataclasses.dataclass
class Band:
    offset: int
    scale: float


def make(cfg: dict, g: torch.Generator, device) -> gen.Data:
    n = int(cfg["n"])
    i = torch.arange(n - 1, device=device)
    rows, cols = [], []
    for band in (Band(1, 1.0), Band(-1, 1.0)):
        rows.append(i if band.offset > 0 else i + 1)
        cols.append(i + 1 if band.offset > 0 else i)
    rows, cols = torch.cat(rows), torch.cat(cols)
    vals = torch.rand(rows.numel(), generator=g, device=device,
                      dtype=torch.float64) * 2.0 - 1.0
    diag = torch.zeros(n, dtype=torch.float64, device=device).index_add_(
        0, rows, vals.abs()) * 2.0 + 1.0
    d = torch.arange(n, device=device)
    return gen._to_data(n, torch.cat([rows, d]), torch.cat([cols, d]),
                        torch.cat([vals, diag]))
'''

# solve() through a wrapper of its own, and its control: the plain
# reference's Neumann sum in bfloat16 in the port's place.
TRIDIAG_SOLVE = '''
"""solve(A, b, method="neumann") on one right-hand side of the pool."""
import types

import numpy as np
import torch

from bench_port import entries, reference


class TridiagSolve(entries.Solve):
    def call(self, A, b):
        return self.port.solve(A, b, method="neumann",
                               epsilon=float(self.config["epsilon"]))


ENTRY = TridiagSolve


def control(data, cell, device):
    A = reference.Coo.of(data, device, torch.bfloat16)

    def answer(_, b):
        x = reference.neumann(
            A, torch.from_numpy(np.asarray(b)).to(device, torch.bfloat16), 30)
        return types.SimpleNamespace(solution=x.double().cpu().numpy(),
                                     converged=True, iterations=30)
    return answer
'''

CELL = "tridiag-12k.solve"
CONFIG = {"name": "tridiag-12k", "kind": "tridiagonal", "n": 12000,
          "epsilon": 1e-6, "checks": {"residual_max": 1e-6, "unconverged": 0},
          "small": {"n": 12000}}
TRAFFIC = {"entry": "tridiag_solve", "pool": 4, "warmup": 1,
           "check_sample": 4, "trace_warmup": 1, "trace_requests": 3}


def _write(path: Path, text: str):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


@pytest.fixture
def found(tmp_path, monkeypatch):
    """The lookup pointed at temporary ``configs/``, ``traffic/``,
    ``kinds/`` and ``calls/`` holding only the new cell's files; returns a
    copy of ``BENCHMARK.json`` with the cell's entries added."""
    for attr, sub in (("CONFIGS_DIR", "configs"), ("TRAFFIC_DIR", "traffic"),
                      ("KINDS_DIR", "kinds"), ("CALLS_DIR", "calls")):
        monkeypatch.setattr(lookup, attr, tmp_path / sub)
    _write(tmp_path / "configs" / "tridiag-12k.json", json.dumps(CONFIG))
    _write(tmp_path / "traffic" / "tridiag.json", json.dumps(TRAFFIC))
    _write(tmp_path / "kinds" / "tridiagonal.py", TRIDIAGONAL)
    _write(tmp_path / "calls" / "tridiag_solve.py", TRIDIAG_SOLVE)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tridiag-12k", "source": "a test fixture",
                             "file": "bench_port/configs/tridiag-12k.json",
                             "reduced": [], "why": "a new kind"})
    bench["workloads"].append({"name": CELL, "config": "tridiag-12k",
                               "traffic": "tridiag", "chips": 1,
                               "why": "a new entry"})
    for m in bench["end_to_end"]:
        if m["name"] == "solutions_per_s":
            m["workloads"].append(CELL)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_new_kind_and_entry_run_correct_from_new_files(small_run, found, seed):
    cell = harness.load_cell(CELL, found)
    assert gen.kind(cell.config["kind"]).__module__.startswith("bench_port_kinds_")
    assert entries.find(cell.traffic["entry"]).__name__ == "TridiagSolve"
    line = small_run(CELL, seed=seed, benchmark=found)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"solutions_per_s", "setup_s"}
    assert line["checks"]["residual_max"]["value"] <= 1e-6


def test_new_entry_brings_its_control_and_it_is_not_correct(small_run, found):
    line = small_run(CELL, impl=control.control, benchmark=found)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["residual_max"]["value"] > 1e-6


def test_new_entry_without_a_control_cannot_be_validated(small_run, found):
    path = lookup.CALLS_DIR / "tridiag_bare.py"
    _write(path, TRIDIAG_SOLVE.split("\n\ndef control")[0] + "\n")
    bench = json.loads(found.read_text())
    bench["workloads"].append({"name": "tridiag-12k.bare", "config": "tridiag-12k",
                               "traffic": "bare", "chips": 1, "why": "no control"})
    found.write_text(json.dumps(bench))
    _write(lookup.TRAFFIC_DIR / "bare.json",
           json.dumps({**TRAFFIC, "entry": "tridiag_bare"}))
    with pytest.raises(SystemExit, match="cannot be validated without one"):
        small_run("tridiag-12k.bare", impl=control.control, benchmark=found)


@pytest.mark.parametrize("piece", ["kind", "entry"])
def test_a_name_found_nowhere_fails_at_load_cell_naming_both_places(found, piece):
    if piece == "kind":
        _write(lookup.CONFIGS_DIR / "tridiag-12k.json",
               json.dumps({**CONFIG, "kind": "no-such-kind"}))
        places = ["gen.KINDS", str(lookup.KINDS_DIR / "no-such-kind.py")]
    else:
        _write(lookup.TRAFFIC_DIR / "tridiag.json",
               json.dumps({**TRAFFIC, "entry": "no_such_entry"}))
        places = ["entries.ENTRIES", str(lookup.CALLS_DIR / "no_such_entry.py")]
    with pytest.raises(LookupError) as err:
        harness.load_cell(CELL, found)
    for place in places:
        assert place in str(err.value)


def test_an_entry_file_must_export_a_subclass_of_entry(found):
    _write(lookup.CALLS_DIR / "not_an_entry.py", "ENTRY = dict\n")
    with pytest.raises(TypeError, match="subclass of entries.Entry"):
        entries.find("not_an_entry")


def test_builtin_kinds_and_entries_resolve_as_before():
    assert gen.kind("random-sparse") is gen.random_sparse
    assert gen.kind("rmat") is gen.rmat
    assert entries.find("solve") is entries.Solve
    assert entries.find("solve_batch") is entries.SolveBatch
    assert entries.find("personalized_pagerank") is entries.PersonalizedPageRank


# sha256 of rows, cols and vals (in that order) made by ``gen.make`` at each
# configuration's small size, as the generators made them before kinds and
# entries could be files
BEFORE = {
    ("rsparse-100k", 7):
        "377a008ef872b13e85ee6c0707fa5292ca6774a922b941567845c95056cfe30c",
    ("rsparse-100k", 2**40 + 3):
        "c3c850929155bff18c6a84d58a10b8844ec7d0a76ee54626ef76f7fc5d4b8e37",
    ("webgraph-rmat-1m", 7):
        "fcf78493f007f56384e662874f7ac9ce039104eae13a6293697cc0fbcf87eeb9",
    ("webgraph-rmat-1m", 2**40 + 3):
        "6a75ef50485522a882c34e8f07047cc45e73b67130906e93de90642674228b9e",
}


@pytest.mark.parametrize("config_name,seed", sorted(BEFORE))
def test_make_gives_the_same_arrays_as_before(config_name, seed):
    cfg = json.loads((lookup.CONFIGS_DIR / f"{config_name}.json").read_text())
    cfg.update(cfg["small"])
    d = gen.make(cfg, gen.generator(seed, "cpu"), "cpu")
    h = hashlib.sha256()
    for a in (d.rows, d.cols, d.vals):
        h.update(a.tobytes())
    assert h.hexdigest() == BEFORE[(config_name, seed)]


def test_a_kind_file_with_a_dataclass_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(lookup, "KINDS_DIR", tmp_path)
    _write(tmp_path / "tridiagonal.py", TRIDIAGONAL)
    make = gen.kind("tridiagonal")
    band = lookup.load(tmp_path, "tridiagonal").Band(1, 2.0)
    assert (band.offset, band.scale) == (1, 2.0)
    d = make({"n": 5}, gen.generator(1, "cpu"), "cpu")
    assert (d.n, d.nnz, d.nnz_diag) == (5, 13, 5)
    assert lookup.load(tmp_path, "tridiagonal") is lookup.load(tmp_path, "tridiagonal")


def test_metrics_load_through_the_same_lookup(tmp_path):
    assert harness.reader("setup_s") is lookup.load(lookup.METRICS_DIR, "setup_s").read
    # two files of one name in two directories stay two modules
    _write(tmp_path / "a" / "same.py", "WHICH = 'a'\n")
    _write(tmp_path / "b" / "same.py", "WHICH = 'b'\n")
    assert [lookup.load(tmp_path / d, "same").WHICH for d in "ab"] == ["a", "b"]
