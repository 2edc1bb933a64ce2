"""Utilities: conversion of operators to and from NumPy, checkpoints,
profiling and roofline accounting (:mod:`.profiling`), trace hooks
(:mod:`.trace`)."""
