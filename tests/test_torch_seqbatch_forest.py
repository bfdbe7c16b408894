"""PyTorch port, the sequential-batch path end to end on the 8-agent
forest with ``Param()``'s defaults (tests/test_pipeline.py's forest, one
joint batch, dense KKT): ``plan()`` + ``evaluate()`` through the JAX
package (x64 on the CPU) and the port (float64, ``device="cpu"``), held
as tests/test_torch_seqbatch_plan.py holds its problems (a file of its
own for the time its 2000 dense iterations take on one CPU thread).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_seqbatch_plan import check_plan, one_thread  # noqa: E402,F401


def test_forest8_default_plan_and_evaluate_match_jax():
    check_plan("forest8-default")
