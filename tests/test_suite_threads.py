"""The suite's one-thread limit (the rootdir's ``conftest.py``) holds in
every worker: without it the workers' BLAS and OpenMP threads spin against
each other and the suite runs past its time limit."""

import os

import numpy as np
import scipy.linalg
import torch
from threadpoolctl import threadpool_info


def test_one_blas_and_openmp_thread_per_worker():
    scipy.linalg.eigh(np.eye(4))  # loads SciPy's BLAS if nothing has yet
    blas = [lib for lib in threadpool_info() if lib["user_api"] == "blas"]
    assert blas and all(lib["num_threads"] == 1 for lib in blas), blas
    assert os.environ["OPENBLAS_NUM_THREADS"] == "1"
    assert torch.get_num_threads() == 1
