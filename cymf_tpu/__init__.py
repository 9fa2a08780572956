"""cymf-tpu: a JAX matrix-factorization framework.

Brand-new JAX/XLA implementation with the capabilities of the
Cython/OpenMP reference library cymf (see SURVEY.md): BPR, WMF (implicit
ALS), ExpoMF, RelMF, GloVe, sampled-negative ranking evaluation with IPS
variants, and MovieLens / Yahoo R3 / text8 dataset loaders.

Top-level API mirrors `/root/reference/cymf/__init__.py:1-7`.
"""

from .models import BPR, WMF, RelMF, ExpoMF, GloVe
from .evaluation.evaluator import (Evaluator, AverageOverAllEvaluator,
                                   AoaEvaluator, UnbiasedEvaluator)
from .evaluation.recommend import recommend
from . import evaluation as evaluator  # cymf exposes `cymf.evaluator.*`
from . import dataset
from . import optim
from .parallel import MeshContext, current_mesh, use_mesh

__version__ = "0.1.0"
__all__ = [
    "BPR", "WMF", "RelMF", "ExpoMF", "GloVe", "Evaluator", "AverageOverAllEvaluator", "AoaEvaluator",
    "UnbiasedEvaluator", "recommend", "dataset", "evaluator", "optim",
    "MeshContext", "current_mesh", "use_mesh",
]
