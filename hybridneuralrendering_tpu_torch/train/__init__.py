"""See the module of the same name in hybridneuralrendering_tpu/train."""
