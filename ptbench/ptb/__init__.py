"""The benchmark harness of ``repro_torch``: spec loading, traffic, weights,
the serving window, the yardstick (counts, peaks, comparison) and the
trace reading. Nothing here imports the program at module level, so the
tests import every module on a machine without a card."""
