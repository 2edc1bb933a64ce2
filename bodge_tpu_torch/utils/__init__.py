"""Utilities: conversion of operators to and from NumPy."""
