"""Inputs for the window programs (port of ``semantic_slam_tpu.parallel``:
``window_inputs`` only; the sharded solver is not ported yet)."""
