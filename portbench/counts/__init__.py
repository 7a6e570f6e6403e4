"""Operation and byte counts, and the table of peaks.

`flops.py` counts the operations of a leaf through the plain model (the
model as `reference/` computes it: a multiply-add is 2, no folds,
elementwise work and norms left out). `kernels.py` counts the bytes and
operations the dequantize and score-argmin steps need. `peaks.json` holds
the published peaks of the card. These count the work the model and the
algorithm need, whatever implements them.
"""
