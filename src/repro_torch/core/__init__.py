"""FedPairing core of the port.  The host-side planners (planning, pairing,
latency, participation) are numpy only; the training side (splitting,
fedpair, aggregation, rounds) runs on torch tensors.  Nothing is imported
here, so importing a planner does not load torch."""
