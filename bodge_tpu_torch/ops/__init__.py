"""Numeric operator layer: block-sparse storage, SpMM, CUDA kernels, KPM."""
