"""Sharded training of the MoE families of
``tests/test_torch_mesh_train_families.py`` on the CPU, in a spawn of
their own: deepseek-v3-671b scaled down (MLA with its MTP head, a dense
and an MoE layer, 8 experts expert-parallel) and jamba-v0.1-52b at its
first 5 layers (Mamba2 mixers with dense and MoE FFNs, an attention
layer with an MoE FFN), each over a ``(data=2, model=2)`` mesh of four gloo ranks
against the reference's unsharded step under ``ShardingHints(dp_size=2,
moe_mode="ep")``, with that file's helpers and tolerances."""

import pytest
import test_torch_mesh_train_families as TF

NAMES = ["deepseek", "jamba"]
setup, ref, ranks = TF.fixtures(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_losses_and_grad_norms_match_reference(ranks, ref, name):
    TF.check_losses(ranks, ref, name)


@pytest.mark.parametrize("name", NAMES)
def test_params_after_each_step_match_reference(setup, ranks, ref, name):
    TF.check_params(setup, ranks, ref, name)


@pytest.mark.parametrize("name", NAMES)
def test_gathered_gradients_match_reference(setup, ranks, ref, name):
    TF.check_grads(setup, ranks, ref, name)


@pytest.mark.parametrize("name", NAMES)
def test_replicated_gradients_equal_on_every_rank(ranks, name):
    TF.check_replicated(ranks, name)


def test_experts_split_over_the_model_axis(ranks):
    """Expert parallelism: each rank holds half of each MoE layer's 8
    experts, deepseek's MTP layer's included, and the router whole."""
    for r in ranks:
        shapes = r["families"]["deepseek"]["shapes"]
        assert shapes["layers/1/ffn/w_up"][0] == 4
        assert shapes["mtp/layer/ffn/w_up"][0] == 4
        assert shapes["layers/1/ffn/router"] == [64, 8]
