"""Evaluation of the port: the rFVD evaluator and its CLIs."""
