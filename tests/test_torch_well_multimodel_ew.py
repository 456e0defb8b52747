"""The 8x8x6 well MultiModel of tests/test_torch_well_multimodel.py on the
schedule path (``simulate_jit``, Eisenstat-Walker forcing, 16 ministep
records) in the port against the JAX package's ``simulate_jit``, on the
CPU at f64: every ministep's Newton and linear iterations, success and dt
equal, states within 1e-12."""

from test_torch_well_multimodel import assert_matches_jax


def test_well_multimodel_schedule_ew_matches_jax():
    assert_matches_jax(product=True)
