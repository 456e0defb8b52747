"""The harness finds every piece of a cell by name, as files of their own,
and takes a new file of each kind without an edit to another."""

import json
import shutil

import pytest

from conftest import BENCH_DIR, ROOT, run_tiny, tiny_cell
from harness import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_pieces_by_name():
    for w in BENCH["workloads"]:
        cell = spec.cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.mix["name"] == w["traffic"]
        assert cell.chips == w["chips"] == 1
        spec.builder(cell.config["builder"])
        spec.reference(cell.config["reference"])
        assert {"cnv", "mb", "start_gap", "repeats_differing",
                "unanswered"} <= set(spec.limits(w["name"]))
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert spec.config(c["name"])["reduced"] == c["reduced"]
    for fn in ("spmv", "gmg"):
        assert spec.kernel_map(fn)["kernels"]


def test_metrics_apply_to_the_cells_they_list():
    eager_only = {"solve_ms_per_linear_it", "assembly_ms_per_newton"}
    for w in BENCH["workloads"]:
        names = {m["name"] for m in spec.cell(ROOT, w["name"]).per_layer}
        assert ("eager" in w["traffic"]) == bool(eager_only & names)
        assert {"case_build_s", "spmv_roofline_pct", "device_idle_pct",
                "newtons_per_sim_day", "sim_days_per_s.traced"} <= names


def test_new_files_of_each_kind_are_taken_without_edits(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and a
    kernel map as new files and one new cell in BENCHMARK.json; the new cell
    runs on the CPU through the same code and reports the new metric."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(bench_dir): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    cfg = json.loads((bench_dir / "configs" / "flagship-1m-wells.json")
                     .read_text())
    cfg.update(name="flagship-small", dims=[10, 10, 6])
    (bench_dir / "configs" / "flagship-small.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench_dir / "mixes" / "eager-3x1d.json").read_text())
    mix.update(name="eager-1x2h", report_steps=1, report_step_s=7200.0,
               rate_ramp=[0.75, 0.75])
    (bench_dir / "mixes" / "eager-1x2h.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "ministeps_per_schedule.py").write_text(
        "def read(ctx):\n"
        "    return ctx.totals.ministeps / ctx.totals.schedules\n")
    (bench_dir / "kernels" / "flux.json").write_text(json.dumps(
        {"function": "flux", "kernels": [r"\bdarcy_flux_jacobian"]}))
    (bench_dir / "limits" / "small-eager.json").write_text(json.dumps(
        {"cnv": 1.0, "mb": 1.0, "start_gap": 1e-6, "repeats_differing": 0,
         "unanswered": 0}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "flagship-small", "source": "test",
                             "file": "benchmark/configs/flagship-small.json",
                             "reduced": ["dims"], "why": "test"})
    bench["workloads"].append({"name": "small-eager",
                               "config": "flagship-small",
                               "traffic": "eager-1x2h", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "ministeps_per_schedule",
                               "unit": "ministeps", "better": "lower",
                               "source": "program_counter",
                               "layer": "Newton loop",
                               "moves": "cell_newtons_per_s",
                               "workloads": ["small-eager"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = {p.relative_to(bench_dir): p.read_bytes()
             for p in bench_dir.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    cell = spec.cell(tmp_path, "small-eager", bench_dir)
    assert cell.config["dims"] == [10, 10, 6]
    assert spec.kernel_map("flux", bench_dir)["function"] == "flux"
    out = run_tiny("small-eager", trace=True, cell=cell)
    assert out["correct"]
    assert out["metrics"]["ministeps_per_schedule"]["value"] >= 1


def test_tiny_cell_prints_the_contract_line(capsys):
    from harness.cell import emit

    out = run_tiny("flagship-product")
    assert emit(out) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"cell_newtons_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    err = captured.err.strip().splitlines()
    names = list(spec.limits("flagship-product"))
    assert [e.split()[1] for e in err[-len(names):]] == names
    assert list(line["checks"]) == names


def test_tiny_spe10_cell_runs_its_own_routes():
    out = run_tiny("spe10-eager", trace=True)
    assert out["correct"], out["checks"]
    assert out["counts"]["sim_days"] == 3.0  # one schedule of 3 days
    c = out["counts"]
    assert c["checked_ministeps"] == c["ministeps"] - c["failed_ministeps"]
    assert {"newtons_per_sim_day", "sim_days_per_s.traced",
            "linear_its_per_newton", "solve_ms_per_linear_it",
            "assembly_ms_per_newton"} <= set(out["metrics"])
    m = out["metrics"]
    assert m["sim_days_per_s.traced"]["value"] * \
        m["newtons_per_sim_day"]["value"] == pytest.approx(
            c["newtons"] / out["device"]["window_s"])
