"""That `correct` can come out false: the control (the plain reference in
the program's place, computed in the precision below the configuration's)
fails the comparison, and a run whose timed path is broken underneath
comes out not correct. At a size a test run holds, on the CPU; the chip
readings at the cells' own size are in PERF.md."""

import pytest

import control
from harness import bench

CELLS = {"tpch-sf10-dbl.join": 0.002, "tpch-sf10-dec.pricing": 0.1}


def cell_config(cell, sf):
    spec = bench.Spec()
    cfg = spec.config(spec.workload(cell)["config"])
    cfg["scale_factor"] = sf
    return spec, cfg


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_comes_out_not_correct(cell):
    spec, cfg = cell_config(cell, CELLS[cell])
    queries = {q: bench.query_module(q)
               for q in bench.mix(spec.workload(cell)["traffic"])["queries"]}
    for seed in (1, 2, 3):
        c = control.control_checks(cfg, queries, seed, 3, "cpu")
        assert any(c[k] > v for k, v in cfg["limits"].items()), (seed, c)


def run(cell):
    spec, cfg = cell_config(cell, 0.002)
    return bench.run_cell(spec, cell, 2**31 + 5, 1e-6, False, device="cpu",
                          config=cfg)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    assert run(cell)["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    """The last value of the first row of every result moved by one unit
    (or one part in a million) as collect() returns it."""
    from spark_rapids_tpu_torch.api import session

    real = session.DataFrame.collect

    def altered(self):
        rows = real(self)
        if rows and rows[0] and rows[0][-1] is not None:
            v = rows[0][-1]
            v = v + 1 if isinstance(v, int) else v * (1 + 1e-6)
            rows[0] = tuple(rows[0][:-1]) + (v,)
        return rows
    monkeypatch.setattr(session.DataFrame, "collect", altered)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_half_of_each_batch_left_out(cell, monkeypatch):
    """Every scan hands the plan the first half of each batch's rows."""
    from spark_rapids_tpu_torch.api import session
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch

    real = session._InMemorySource.batches

    def halved(self):
        return [ColumnarBatch(b.columns, b.num_rows_host // 2, b.schema)
                for b in real(self)]
    monkeypatch.setattr(session._InMemorySource, "batches", halved)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_query_that_raises_is_counted_failed(cell, monkeypatch):
    """Past the warm-up, every collect() raises: the window counts each
    query failed and the run is not correct."""
    from spark_rapids_tpu_torch.api import session

    real, calls = session.DataFrame.collect, []
    warm = len(bench.mix(bench.Spec().workload(cell)["traffic"])["queries"])

    def boom(self):
        calls.append(1)
        if len(calls) > warm:
            raise RuntimeError("injected")
        return real(self)
    monkeypatch.setattr(session.DataFrame, "collect", boom)
    out = run(cell)
    assert out["failed"] == out["attempted"] > 0 and not out["correct"]


@pytest.mark.cuda
def test_a_cell_on_the_card_at_a_small_size():
    """The whole run on the card, at SF 0.01 (run on the chip's machine)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec, cfg = cell_config("tpch-sf10-dbl.join", 0.01)
    out = bench.run_cell(spec, "tpch-sf10-dbl.join", 17, 1.0, True,
                         device="cuda", config=cfg)
    assert out["correct"] and out["device"]["busy_s"] > 0
