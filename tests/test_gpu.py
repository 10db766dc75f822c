"""Checks that need the card: the spread kernel compiled through Triton
(never interpreted) against the XLA scatter and the dense oracle. The
same functions are phases of ``chip_smoke.py``. Skips without a GPU."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("grid,m", [((64, 64), 20_000),
                                    ((32, 32, 32), 50_000)])
def test_compiled_spread_kernel_matches_scatter(gpu, grid, m):
    err, _, _, _ = chip_smoke.check_spread_kernel(grid, m)
    assert err < 1e-5


def test_compiled_type1_matches_oracle(gpu):
    err, err_impl, _, _ = chip_smoke.check_type1_2d(m=20_000,
                                                    grid=(64, 64))
    assert err < 1e-5 and err_impl < 1e-5
