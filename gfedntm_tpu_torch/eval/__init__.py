"""Topic-model evaluation: numpy copies of ``gfedntm_tpu/eval`` modules."""
