"""See the package of the same name in hybridneuralrendering_tpu."""

from hybridneuralrendering_tpu_torch.parallel import mesh  # noqa: F401
