"""Step factories of the LM stack (``train_step``)."""
