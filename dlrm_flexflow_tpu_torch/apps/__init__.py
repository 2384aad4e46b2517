"""Applications built on the port (counterparts of
``dlrm_flexflow_tpu/apps``); this slice ports the DLRM."""
