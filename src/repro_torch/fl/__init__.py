# importing the package registers the faulty scenarios, as in the JAX package
from repro_torch.fl import faults  # noqa: F401
