"""The cuts at which ``chip_smoke.py`` trains the five P14c configurations
on the card (``chip_smoke.P14C``: 3 launcher steps of 1 x 2,048 with
remat), checked on meta tensors: no data, no card.

* The cut ``--layers`` makes (``launch.train.cut_config``) holds the
  parameter count the script's comments state, and so its state
  (weights, gradients and two AdamW moments: 16 B a parameter).
* ``chip_smoke.train_launches(model, remat=True)`` expects K4's forward
  twice and its backward once a layer for the four attention models
  (every layer sits in a pattern group, whose forward remat runs again)
  and no kernel for deepseek's MLA layers, where it raised ``KeyError``;
  ``chip_smoke.train_blocks`` expects deepseek's MLA and MoE calls.
* deepseek's cut keeps its dense first layer, and its replay cut (2
  layers) is that layer and one MoE layer.
"""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.configs.base import get_config
from repro_torch.launch.train import cut_config
from repro_torch.models.model import get_model
from repro_torch.training.optim import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
DEEPSEEK = "deepseek-v2-lite-16b"

# arch -> (layers trained, of, parameters at the cut, state GB at the cut)
CUTS = {"qwen3-4b": (36, 36, 4_022_468_096, 64.4),
        "musicgen-large": (48, 48, 3_229_812_736, 51.7),
        "glm4-9b": (10, 40, 3_281_080_320, 52.5),
        DEEPSEEK: (5, 27, 2_839_831_040, 45.4),
        "qwen3-32b": (3, 64, 3_018_624_768, 48.3)}


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` as a module: its top level imports only the
    standard library and runs nothing."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cut(chip_smoke, arch):
    cfg = get_config(arch)
    layers, _ = chip_smoke.P14C[arch]
    return get_model(cut_config(cfg, layers or cfg.num_layers))


def test_the_script_trains_the_five(chip_smoke):
    assert list(chip_smoke.P14C) == list(CUTS)
    assert (chip_smoke.P14C_B, chip_smoke.P14C_S,
            chip_smoke.P14C_STEPS) == (1, 2048, 3)


@pytest.mark.parametrize("arch", list(CUTS))
def test_cut_parameters_and_state(chip_smoke, arch):
    layers, of, n_want, state_gb = CUTS[arch]
    model = _cut(chip_smoke, arch)
    assert (model.cfg.num_layers, get_config(arch).num_layers) == (layers,
                                                                   of)
    leaves = tree_leaves(model.abstract())
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert n == n_want
    assert round(16 * n / 1e9, 1) == state_gb


@pytest.mark.parametrize("arch", list(CUTS))
def test_train_launches_and_blocks(chip_smoke, arch):
    model = _cut(chip_smoke, arch)
    L = model.cfg.num_layers
    want = chip_smoke.train_launches(model, remat=True)
    blocks = chip_smoke.train_blocks(model, remat=True)
    if arch == DEEPSEEK:
        assert set(model.block_types) == {"mla"}
        assert want == {} == chip_smoke.train_launches(model)
        # the dense head layer once, each grouped MoE layer twice
        assert blocks == {"mla_apply": 1 + 2 * (L - 1),
                          "moe_apply": 2 * (L - 1)}
        assert chip_smoke.train_blocks(model) == {"mla_apply": L,
                                                  "moe_apply": L - 1}
    else:
        assert all(g for _, _, g in model.layer_spans())
        assert want == {"flash_attention": 2 * L, "flash_attention_bwd": L}
        assert chip_smoke.train_launches(model) == {
            "flash_attention": L, "flash_attention_bwd": L}
        assert blocks == {"mla_apply": 0, "moe_apply": 0}


def test_deepseek_cuts_keep_the_dense_first_layer(chip_smoke):
    model = _cut(chip_smoke, DEEPSEEK)
    assert model.layer_spans()[0] == (0, 1, False)
    tables = [model.layer_table(i) for i in range(model.cfg.num_layers)]
    assert "mlp" in tables[0] and "moe" not in tables[0]
    assert all("moe" in t and "mlp" not in t for t in tables[1:])
    # the card-vs-CPU replay's cut: the dense layer and one MoE layer
    replay = get_model(cut_config(get_config(DEEPSEEK),
                                  chip_smoke.P12A_CUT_LAYERS))
    assert ["moe" in replay.layer_table(i) for i in range(2)] == [False,
                                                                 True]
    with pytest.raises(SystemExit):
        cut_config(get_config(DEEPSEEK), 28)
