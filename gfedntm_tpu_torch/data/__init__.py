"""Host data layer: numpy copies of ``gfedntm_tpu/data`` modules."""
