"""Attack auxiliaries: objectives, regularizers, optimizers, initializations."""
