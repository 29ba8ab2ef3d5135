"""Benchmark evaluation (the JAX package's ``evals/``): metrics and their
CSV, prediction-to-ground-truth alignment, the temporal alignment error,
the dataset driver ``evaluate_dataset`` and the comparison renderings."""
