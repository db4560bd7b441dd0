"""See the package of the same name in hybridneuralrendering_tpu."""
