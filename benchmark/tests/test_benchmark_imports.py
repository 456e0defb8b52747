"""The check that no module of JAX or of the JAX package is loaded, by
whole name components, at the end of every run."""

import json
import sys
import types

import pytest

from harness.imports import forbidden_modules, is_forbidden


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("jutul.jl_tpu", True),
    ("jutul.jl_tpu.models.darcy", True),
    ("jutul.jl_tpu_torch", False), ("jutul.jl_tpu_torch.ops.cuda", False),
    ("jutul", False), ("jaxtyping", False), ("jax_helpers", False),
    ("mypkg.jax", False), ("jutul.jl_tpux", False), ("torch", False),
])
def test_whole_component_rule(name, bad):
    assert is_forbidden(name) is bad


def test_forbidden_modules_lists_only_forbidden_names():
    assert forbidden_modules(["jutul.jl_tpu_torch", "jax", "numpy",
                              "jutul.jl_tpu.core"]) == ["jax",
                                                        "jutul.jl_tpu.core"]


def test_a_run_loads_no_jax(capsys):
    from conftest import run_tiny
    from harness.cell import emit

    out = run_tiny("flagship-product")
    assert forbidden_modules() == []
    assert emit(out) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["correct"]


def test_end_of_run_check_refuses_a_loaded_jax(capsys, monkeypatch):
    from harness.cell import emit

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "jutul.jl_tpu",
                        types.ModuleType("jutul.jl_tpu"))
    out = {"correct": True, "checks": {}}
    assert emit(out) != 0
    captured = capsys.readouterr()
    assert captured.out == ""  # no result
    assert "jax" in captured.err and "jutul.jl_tpu" in captured.err
