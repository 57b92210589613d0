"""Device-side model of the port: the EWMA estimator, the swarm
simulator and its hand-written kernels."""
