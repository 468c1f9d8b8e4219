"""PyTorch port: the options a model refuses, its default device, and
``to_numpy``; f64 on the CPU."""
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.kernels import RBF, Matern32
from _torch_model import _data

torch.set_num_threads(1)


def test_unported_options_raise():
    """``mesh`` (the time-sharded engines) raises naming A13; ``stable=True``
    builds a model on the square-root engine."""
    t, y = _data(10, 0)
    k = Matern32(1.0, 0.5, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="A13"):
        StateSpaceGP.create((t, y), k, 0.1, dtype=torch.float64, device="cpu", mesh=object())
    model = StateSpaceGP.create((t, y), k, 0.1, dtype=torch.float64, device="cpu", stable=True)
    assert model.engine() == ("sqrt", None) and model.stable


@pytest.mark.parametrize("build", ["from_numpy", "create", "kernel", "rbf"])
def test_default_device_is_the_card_and_raises_without_one(build):
    """``device=None`` means the card at every entry point that creates
    tensors; where there is none (as here) it raises and names
    ``device="cpu"`` instead of carrying on on the CPU."""
    from parallel_gps_torch import config

    assert config.default_device() == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    t, y = _data(10, 0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if build == "from_numpy":
            StateSpaceGP.from_numpy(t, y, "Matern32", 1.0, 0.5, 0.1, dtype=torch.float64)
        elif build == "create":
            StateSpaceGP.create((t, y), Matern32(1.0, 0.5, dtype=torch.float64, device="cpu"), 0.1, dtype=torch.float64)
        elif build == "kernel":
            Matern32(1.0, 0.5, dtype=torch.float64)
        else:
            RBF(1.0, 0.5, order=4, dtype=torch.float64)


def test_to_numpy_inverts_from_numpy():
    t, y = _data(10, 0)
    tm = StateSpaceGP.from_numpy(t, y, "Matern52", 0.7, 1.9, 0.25, dtype=torch.float64, device="cpu")
    got = tm.to_numpy()
    assert {k: v.shape for k, v in got.items()} == {"variance": (), "lengthscales": (), "noise_variance": ()}
    npt.assert_allclose([got["variance"], got["lengthscales"], got["noise_variance"]], [0.7, 1.9, 0.25], rtol=1e-14)
