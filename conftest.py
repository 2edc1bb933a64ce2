"""Every test process runs one BLAS / OpenMP thread.

pytest loads this file, the rootdir's, before ``tests/conftest.py`` and
before any test module, in the controller and in every xdist worker.  So
NumPy, SciPy, jaxlib and torch read the variables below when they load, and
the processes that tests spawn inherit them.

Each worker's OpenBLAS would otherwise fan every small eigh, QR and product
out to all cores, and the suite's six workers spin against each other.  On
an 8-core CPU the 150-step dense ``solve_gap`` of
``tests/test_selfconsistency.py`` takes 7.1 s alone on one pinned core; six
copies side by side with the default threads did not finish in 200 s, and
with one thread each they took 5.6-5.9 s, 12 s of wall for all six.
``tests/test_suite_threads.py`` checks that the limit holds.
"""

import os

for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")

try:  # for a BLAS library loaded before the variables were set
    from threadpoolctl import threadpool_limits
except ImportError:  # the variables alone then set the limit
    pass
else:
    threadpool_limits(limits=1, user_api="blas")
