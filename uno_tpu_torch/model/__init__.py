"""Models: the NLP, its reformulations and the problem registry.

Importing the package imports model.library, which fills the registry
from its side modules (as uno_tpu/model/__init__.py does); a side module
imported first would otherwise see the others half built."""

from uno_tpu_torch.model import library  # noqa: F401
