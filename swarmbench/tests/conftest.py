import sys
from pathlib import Path

import pytest

# the checkout's root, where swarmbench and the program live
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    # one intra-op thread, never raised again (several break this torch
    # build's batched LU inverse on the CPU)
    import torch

    torch.set_num_threads(1)
