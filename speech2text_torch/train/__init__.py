"""Training of the port: the flagship train step (`step.TrainStep`)."""
