"""Communication planning for the training loop (``plan``): the paper's
scheduler applied to a training step's gradient reductions."""
