"""Train state, checkpoints and the train driver."""
