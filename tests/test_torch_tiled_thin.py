"""PyTorch port, the tiled Chebyshev step on thin lattices: extents of 1 (an
axis without slots) and of 2 (wrap and bond coincide: one slot, and one
padding slot that must be skipped whatever it holds), open and periodic.
The comparison is that of ``test_torch_tiled.py``; the cases live in a file of
their own so that no test file of the port outgrows the others (the suite's
scheduler starts the files with the most tests first)."""

import pytest

from tests.test_torch_tiled import check_tiled_plain_against_general
from tests._reference_compiles import unoptimised_reference_compiles  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("shape", [(2, 6, 1), (2, 2, 2), (16, 1, 1), (1, 1, 7), (1, 1, 1)])
@pytest.mark.parametrize("pbc", [False, True], ids=["open", "periodic"])
def test_tiled_plain_matches_general_step_thin(shape, pbc):
    check_tiled_plain_against_general(shape, pbc)
