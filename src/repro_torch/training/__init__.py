"""Step functions of the port: the serving steps (training waits for its
slice, ROADMAP A11)."""
