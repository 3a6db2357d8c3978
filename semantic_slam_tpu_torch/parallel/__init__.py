"""Several ranks (port of ``semantic_slam_tpu.parallel``): the mesh on
``torch.distributed`` (``dist``), the edge-sharded dense LM and the sharded
window step (``sharded``), and the window programs' inputs
(``window_inputs``)."""
