"""Training: the train state and the hot train step (``train_state``)."""
