"""Command-line entry points: train / evaluate / infer."""
