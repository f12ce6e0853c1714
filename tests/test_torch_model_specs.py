"""Every registered configuration's tensor declarations at its reduced size:
the weights drawn with seed 0 on the CPU are pinned bit for bit, the decode
cache's tree, shapes, dtypes and initial values are pinned, and the
logical-axes trees line up with the trees they describe (the same keys in
the same order, one axis name per dim).

The digests were recorded from the twin ``*_init`` / ``*_axes`` functions
that the spec trees replaced: the same seed still draws the same weights,
in the same order, with the same float32-then-cast draw (granite-4.0-h-small's,
added later, were recorded from its spec tree).  A change that
means to alter a configuration's tensors prints the new digests with
``PYTHONPATH=src python tests/test_torch_model_specs.py``.
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.layers import torch_dtype  # noqa: E402

WEIGHTS = {
    "chameleon-34b": "0de4c8e49f9767946ad009a6bcea7ad1da365e732d1f6e50a46720285c42fb8f",
    "gemma-2b": "75486e3d57c523cdbf462d65b6aeb5cf7180a0bcd3b0306109a5816b99f6f517",
    "granite-3-8b": "75486e3d57c523cdbf462d65b6aeb5cf7180a0bcd3b0306109a5816b99f6f517",
    "granite-4.0-h-small": "45990ce1bbd595040f14a99fd6f64be630109d3b744d8bcb76df8fc0cc8e4531",
    "llama4-scout-17b-a16e": "b0403a3a8d787db5cea245cade597681c39fbad17ae6d8286f46005ece32dd67",
    "moonshot-v1-16b-a3b": "d78049a699f123cdc6ea2cb789fb1ab9acca344ee82656f8b3956f01dadaa772",
    "paper-lm-100m": "a82de4d697590fc03909a67f001d0512e1151fbb8012be764f0e6e3dd9caaa9f",
    "qwen1.5-0.5b": "dd422682f8e4210986e959e0777af93c22cd639e0537f838678c0ad9899d387c",
    "stablelm-1.6b": "4b31132332970877e490b33e79fbd2450500e40f0635b40f0fc09b356f0b8347",
    "whisper-small": "29ad2eccfea694d52473f4bac990c2b15c61ced8fbe877d8c10e32de541914aa",
    "xlstm-125m": "09002ae5e8b286e37a8cbd4ce9c47b68c2ca5c62a7d05fddb1e8c9d5211e92e0",
    "zamba2-1.2b": "f2c44b528fcf5f86ddbe87622ef1caefbdc95355340ac80062c82c97fd101bdf",
    "zamba2-7b": "613169f1dcf9fc3092e2ea7ae8d352426e4c2edec6f507689bd94904803ab5f7",
}
CACHES = {
    "chameleon-34b": "026bd2a5d21b809bd73cf64af5dc034a33b6a2b3f64c32066c2fb51d1b0c5ebe",
    "gemma-2b": "026bd2a5d21b809bd73cf64af5dc034a33b6a2b3f64c32066c2fb51d1b0c5ebe",
    "granite-3-8b": "026bd2a5d21b809bd73cf64af5dc034a33b6a2b3f64c32066c2fb51d1b0c5ebe",
    "granite-4.0-h-small": "75dc0b0c5ae2fe4291c236e33cc5ade9f9d8bc016f792f6531d1bd499e77376c",
    "llama4-scout-17b-a16e": "026bd2a5d21b809bd73cf64af5dc034a33b6a2b3f64c32066c2fb51d1b0c5ebe",
    "moonshot-v1-16b-a3b": "059039f04f0c8a1db671ffec163eda5415787c41a345dd57c92a74c6a5b3e1b7",
    "paper-lm-100m": "059039f04f0c8a1db671ffec163eda5415787c41a345dd57c92a74c6a5b3e1b7",
    "qwen1.5-0.5b": "059039f04f0c8a1db671ffec163eda5415787c41a345dd57c92a74c6a5b3e1b7",
    "stablelm-1.6b": "059039f04f0c8a1db671ffec163eda5415787c41a345dd57c92a74c6a5b3e1b7",
    "whisper-small": "1958f4def32e6aa5224efdbe0ed015ec5739874186455706b8ba065d1a8354bc",
    "xlstm-125m": "942e09e3eec782ff82f82b4daee73f62a91e7337f4a3712968d9b59a90b50b07",
    "zamba2-1.2b": "c194177066b5b1de8e5c66761ac3679329604cbbe08adb0cfc638537dcd3390a",
    "zamba2-7b": "223310d061df640ba8fb938a2beedd1ac239b9a333e0db3ecf9c68eaf8a91997",
}


def _walk(tree, path=""):
    """(path, leaf) of every leaf of a tree of dicts and lists, in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, tree


def _digest(tree) -> str:
    """sha256 over every leaf's path, shape, dtype and bytes in tree order
    (an int leaf, the cache's index, by its value)."""
    h = hashlib.sha256()
    for path, t in _walk(tree):
        if not isinstance(t, torch.Tensor):
            h.update(f"{path}:{t!r};".encode())
            continue
        h.update(f"{path}:{tuple(t.shape)}:{t.dtype}:".encode())
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _api(arch):
    return build(get_config(arch).reduced())


def _cache(api):
    return api.make_decode_cache(2, 8, torch_dtype(api.cfg.dtype), "cpu")


@pytest.mark.parametrize("arch", list_archs())
def test_seed_zero_draws_the_pinned_weights(arch):
    api = _api(arch)
    assert _digest(api.init(torch.Generator().manual_seed(0), "cpu")) == WEIGHTS[arch]
    assert _digest(_cache(api)) == CACHES[arch]


@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_is_init_trees_shape(arch):
    api = _api(arch)

    def check(axes, tree):
        if isinstance(tree, dict):
            assert list(axes) == list(tree)
            for k in tree:
                check(axes[k], tree[k])
        elif isinstance(tree, list):
            assert len(axes) == len(tree)
            for a, t in zip(axes, tree):
                check(a, t)
        elif isinstance(tree, torch.Tensor):
            assert isinstance(axes, tuple) and len(axes) == tree.dim(), (axes, tree.shape)
        else:  # the cache's int index
            assert axes == ()

    check(api.param_axes(), api.init(torch.Generator().manual_seed(0), "cpu"))
    for long in (False, True):
        check(api.decode_cache_axes(long), _cache(api))


if __name__ == "__main__":  # print the digests of the tree as it stands
    for a in list_archs():
        api = _api(a)
        print(a, _digest(api.init(torch.Generator().manual_seed(0), "cpu")), _digest(_cache(api)))
