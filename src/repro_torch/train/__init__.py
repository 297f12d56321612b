"""Training substrate of the port: the optimizers (``optim``), the
synthetic data pipeline (``data``) and the checkpointer, which the
trainer and the Louvain cascade's stage checkpoint/resume use."""
