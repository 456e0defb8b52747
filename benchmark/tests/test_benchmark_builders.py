"""The frozen case builders: the seed draws the fields, and seed 0 of the
flagship's is chip_smoke.py's flagship."""

import numpy as np
import pytest

from conftest import ROOT
from harness import spec
from harness.case import program_case, rate_scales

SMALL = [12, 10, 8]


def _flagship_cfg():
    return dict(spec.config("flagship-1m-wells"), dims=SMALL)


def test_seed_0_is_chip_smokes_flagship():
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    case = spec.builder("well_flagship").build(_flagship_cfg(), 0)
    ours = program_case(case, rate_scales(3, (0.75, 1.25)))
    theirs = chip_smoke.build_well_flagship(*SMALL)
    ramp = chip_smoke.rate_schedule(theirs[3], 3)
    (m1, s1, p1, f1), (m2, s2, p2, _) = ours, theirs
    assert m1.number_of_cells() == m2.number_of_cells()
    for k in s2:
        np.testing.assert_array_equal(np.asarray(s1[k]), np.asarray(s2[k]))
    for k in p2:
        np.testing.assert_array_equal(np.asarray(p1[k]), np.asarray(p2[k]))
    for a, b in zip(f1, ramp):
        np.testing.assert_array_equal(a["rate"].cells, b["rate"].cells)
        np.testing.assert_array_equal(a["rate"].values, b["rate"].values)
        np.testing.assert_array_equal(a["bhp"].cells, b["bhp"].cells)
        np.testing.assert_array_equal(np.ravel(a["bhp"].pressure),
                                      np.ravel(b["bhp"].pressure))
        np.testing.assert_array_equal(np.ravel(a["bhp"].trans),
                                      np.ravel(b["bhp"].trans))


@pytest.mark.parametrize("builder, config", [
    ("well_flagship", "flagship-1m-wells"),
    ("spe10_five_spot", "spe10-model2")])
def test_the_seed_draws_the_fields(builder, config):
    """One seed gives the same arrays each time; other seeds, large ones
    too, other permeabilities (and the flagship's saturations), and the
    wells' indices follow the field."""
    b = spec.builder(builder)
    cfg = dict(spec.config(config), dims=SMALL)
    seeds = (0, 1, 2 ** 31 + 11, 2 ** 32 + 15)
    cases = [b.build(cfg, s) for s in seeds]
    again = b.build(cfg, seeds[2])
    np.testing.assert_array_equal(again.perm, cases[2].perm)
    np.testing.assert_array_equal(again.sw0, cases[2].sw0)
    perms = {c.perm.tobytes() for c in cases}
    assert len(perms) == len(seeds)
    if builder == "well_flagship":
        assert len({c.sw0.tobytes() for c in cases}) == len(seeds)
    else:
        a, c = cases[0], cases[1]
        assert not np.array_equal(a.wells[0].wi, c.wells[0].wi)
        for w in a.wells:
            ratio = w.wi / a.perm[w.cells]
            np.testing.assert_allclose(ratio, ratio[0], rtol=1e-12)


def test_spe10_builder_states_the_published_numbers():
    cfg = dict(spec.config("spe10-model2"), dims=[6, 8, 5])
    case = spec.builder("spe10_five_spot").build(cfg, 1)
    assert [w.name for w in case.wells] == ["inj", "prod0", "prod1",
                                            "prod2", "prod3"]
    assert all(len(w.cells) == 5 for w in case.wells)
    assert case.fluid["viscosities"] == pytest.approx((3e-4, 3e-3))
    assert case.fluid["densities"] == pytest.approx((1025.18, 848.98),
                                                   abs=0.01)
    (name, q), = case.rate
    assert name == "inj" and q[0] == pytest.approx(9.4326, rel=1e-4)
    assert all(b[1] == pytest.approx(4000 * 6894.757293168)
               for b in case.bhp)
    assert np.all(case.sw0[:case.n_lattice] == 0.2)
