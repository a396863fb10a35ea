"""Cascade definitions (tasks, thresholds) shared by the serving plane."""
