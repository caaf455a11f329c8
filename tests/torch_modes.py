"""Mode fixture shared by the port's tests that build static programs.

``import paddle_tpu_torch`` starts in dygraph mode, as the reference does.
A test file that builds static programs binds this fixture with
``from torch_modes import static_mode``: the file then runs in static mode
and the mode it found is restored after its last test.
"""
import pytest


@pytest.fixture(autouse=True, scope="module")
def static_mode():
    import paddle_tpu_torch

    was_dygraph = paddle_tpu_torch.in_dygraph_mode()
    paddle_tpu_torch.enable_static()
    try:
        yield
    finally:
        if was_dygraph:
            paddle_tpu_torch.disable_static()
