"""Training: losses, learning-rate schedules, optimizers, the train state,
the output-space adaptation step and its assembly from a Config."""
