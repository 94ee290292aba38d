"""Every host call of the port that blocks on the card is named: a small
MinkUNet18 train step, a MinkUNet18 request and a Volt-s train step run
under ``torch.cuda.set_sync_debug_mode("warn")``, and each synchronisation
the warnings report must be raised inside an open ``wcn.sync.*`` span
(``tracing.open_spans()``, which holds the spans while recording).

The inputs are made on the card before the checked region, as a data
loader would hand them over. Needs an NVIDIA GPU with nvcc (sm_90) and
skips elsewhere; imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu_sync.py -q
"""

import warnings

import numpy as np
import pytest
import torch

from warpconvnet_tpu_torch import constants, tracing
from warpconvnet_tpu_torch.geometry.voxels import Voxels
from warpconvnet_tpu_torch.models.mink_unet import MinkUNet18
from warpconvnet_tpu_torch.models.volt import build_volt
from warpconvnet_tpu_torch.ops.keys import PAD_COORD
from warpconvnet_tpu_torch.parallel.train import make_segmentation_train_step
from warpconvnet_tpu_torch.utils.scenes import make_surface_scene

pytestmark = pytest.mark.gpu

CLASSES = 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    constants.set_compute_dtype("bfloat16")
    yield torch.device("cuda")
    constants.set_compute_dtype(None)


def _batch(device, n_cap=32768, n_points=30_000, seed=0):
    rng = np.random.default_rng(seed)
    coords = np.full((2, n_cap, 3), PAD_COORD, np.int32)
    nv = np.zeros((2,), np.int32)
    for i in range(2):
        c = make_surface_scene(rng, n_cap, coord_range=256, n_points=n_points - 5000 * i)
        nv[i] = len(c)
        coords[i, : len(c)] = c
    feats = rng.standard_normal((2, n_cap, 3)).astype(np.float32)
    vox = Voxels.create(coords, feats, nv, device=device).lex_sort()
    labels = torch.randint(0, CLASSES, (2, n_cap), generator=torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    return vox, labels.to(device)


def _unnamed_syncs(fn):
    """Runs ``fn`` while recording under the sync debug mode; returns (the
    synchronisations, those raised outside every ``wcn.sync.*`` span)."""
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            seen.append((str(message).splitlines()[0], tracing.open_spans()))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        with tracing.recording():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return seen, [s for s in seen if not any(n.startswith("wcn.sync.") for n in s[1])]


def _train(model, vox, labels):
    step = make_segmentation_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                                        CLASSES)
    step(vox, labels)  # the first step: lazily built state and the kernels' build
    torch.cuda.synchronize()
    return _unnamed_syncs(lambda: step(vox, labels))


def test_minkunet18_step_syncs_are_named(cuda):
    vox, labels = _batch(cuda)
    model = MinkUNet18(3, CLASSES, device=cuda, generator=torch.Generator().manual_seed(0))
    seen, unnamed = _train(model, vox, labels)
    assert not unnamed, unnamed
    assert seen  # the strided maps copy their constants to the card


def test_minkunet18_request_syncs_are_named(cuda):
    vox, _ = _batch(cuda, seed=1)
    model = MinkUNet18(3, CLASSES, device=cuda, generator=torch.Generator().manual_seed(0)).eval()

    def request():
        with torch.inference_mode():
            model(vox).features

    seen, unnamed = _unnamed_syncs(request)
    assert not unnamed, unnamed
    assert seen


def test_volt_s_step_syncs_are_named(cuda):
    vox, labels = _batch(cuda, seed=2)
    model = build_volt("volt-s", 3, CLASSES, depth=2, token_capacity=16384, device=cuda,
                       generator=torch.Generator().manual_seed(0))
    seen, unnamed = _train(model, vox, labels)
    assert not unnamed, unnamed
    assert seen
