"""Training substrate of the port: so far the checkpointer, which the
Louvain cascade's stage-boundary checkpoint/resume uses."""
