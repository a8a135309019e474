"""The harness's CPU tests run the program's plain twins through whole
runs of a cell. Under several test workers a torch pool a worker, each
as wide as the machine, oversubscribes the cores, so these tests use one
torch thread and give the worker's setting back afterwards."""
import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
