"""treeqp_tpu_torch — the PyTorch + CUDA port of ``treeqp_tpu``.

The JAX package ``treeqp_tpu`` is the reference; this package mirrors its
module paths (``core/``, ``solvers/``, ``ops/``, ``utils/``) so that each
counterpart is found under the same name. It imports ``torch`` and never
``jax``. Problem data lives in f64 tensors on an explicit device; the
hand-written CUDA kernels under ``csrc/`` run in f32, as the Pallas kernels
they replace did. On a CPU tensor every kernel wrapper runs its plain
PyTorch twin instead (the tests' path); on a CUDA tensor it launches the
kernel or raises.
"""

import torch

# Full-precision f32 everywhere: a TF32 product keeps ~3 decimal digits,
# which would break the f32 factorizations the Newton directions rest on
# (counterpart of treeqp_tpu/__init__.py's "highest" matmul precision).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from treeqp_tpu_torch.utils.tree import TreeStructure, number_of_nodes_multistage  # noqa: E402
from treeqp_tpu_torch.core.qp_data import (  # noqa: E402
    EliminatedTreeQP, TreeQPIn, TreeQPOut, TREEQP_INF)
from treeqp_tpu_torch.core.kkt import kkt_residuals, max_kkt_residual  # noqa: E402
from treeqp_tpu_torch.solvers.tdunes import TdunesOpts, tdunes_solve  # noqa: E402
from treeqp_tpu_torch.solvers.tdunes_multistage import (  # noqa: E402
    MultistageQP, split_multistage, tdunes_ms_solve, merge_output)
from treeqp_tpu_torch.solvers.ipm import IpmOpts, ipm_solve  # noqa: E402
from treeqp_tpu_torch.solvers.ipm_multistage import ipm_ms_solve  # noqa: E402
from treeqp_tpu_torch.solvers.sdunes import (  # noqa: E402
    SdunesOpts, sdunes_solve, scenario_data, scenario_duals_from_tree, scenario_output)
from treeqp_tpu_torch.core.soft import soften_bounds, recover_soft  # noqa: E402
from treeqp_tpu_torch.core.json_io import load_tree_qp_file, load_tree_qp_json  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "TreeStructure",
    "number_of_nodes_multistage",
    "TreeQPIn",
    "TreeQPOut",
    "EliminatedTreeQP",
    "TREEQP_INF",
    "kkt_residuals",
    "max_kkt_residual",
    "TdunesOpts",
    "tdunes_solve",
    "MultistageQP",
    "split_multistage",
    "tdunes_ms_solve",
    "merge_output",
    "IpmOpts",
    "ipm_solve",
    "ipm_ms_solve",
    "SdunesOpts",
    "sdunes_solve",
    "scenario_data",
    "scenario_duals_from_tree",
    "scenario_output",
    "soften_bounds",
    "recover_soft",
    "load_tree_qp_file",
    "load_tree_qp_json",
]
