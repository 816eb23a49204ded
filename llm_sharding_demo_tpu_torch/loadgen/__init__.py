"""Load profiles' declared SLO contracts (the JAX package's
``loadgen``; the load generator waits for ROADMAP Queue 1 item 15b)."""
