"""The plain reference on the CPU: it agrees with itself across block
sizes, its tile index and batches are the program's, and at float32 it
follows the program's run step for step (the same draws, the same
winners) to rounding."""
import numpy as np
import pytest
import torch

from benchmark import reference as R
from benchmark.tests.cpu import small_run


def _head_inputs(seed=0, n=50, e=3000, f=16):
    g = torch.Generator().manual_seed(seed)
    P = {"edge_prob_mlp.head.fc1.weight": torch.randn(f, 2 * f, generator=g)
         * 0.2,
         "edge_prob_mlp.head.fc1.bias": torch.randn(f, generator=g) * 0.1,
         "edge_prob_mlp.head.fc2.weight": torch.randn(1, f, generator=g),
         "edge_prob_mlp.head.fc2.bias": torch.randn(1, generator=g)}
    h = torch.randn(n, f, generator=g)
    s = torch.randint(0, n, (e,), generator=g)
    r = torch.randint(0, n, (e,), generator=g)
    return P, h, s, r


@pytest.mark.parametrize("block", [1, 7, 512, 1 << 17])
def test_the_head_agrees_with_itself_across_block_sizes(block):
    P, h, s, r = _head_inputs()
    seed = torch.tensor([12345], dtype=torch.int32)
    whole = R.head(P, h, s, r, 0.3, seed, R.F32, block=1 << 20)
    got = R.head(P, h, s, r, 0.3, seed, R.F32, block=block)
    assert torch.equal(got == 0, whole == 0)
    assert float((got - whole).abs().max()) < 1e-6


def test_the_dropout_hash_matches_the_port():
    from sgs_gnn_tpu_torch.ops.dropout import hash32_plain
    c = torch.arange(0, 1 << 20, 977, dtype=torch.int64)
    for seed in (0, 1, 2 ** 31 - 2):
        assert torch.equal(R.hash32(torch.tensor([seed]), c),
                           hash32_plain(seed, c))


def test_the_tile_index_is_the_ports():
    from sgs_gnn_tpu_torch.ops.score_tiles import build_tile_index
    rng = np.random.default_rng(3)
    s = rng.integers(0, 300, 20000)
    r = np.sort(rng.integers(0, 300, 20000))
    want = build_tile_index(s, r, 300)
    got = R.tile_index(s, r, 300)
    for k in ("ls", "lr", "su", "rv", "perm", "valid"):
        assert np.array_equal(got[k], getattr(want, k)), k


def test_float8_rounding_passes_the_gradient_through():
    x = torch.tensor([0.1, 1.3, 300.0], requires_grad=True)
    y = R.FP8(x)
    assert not torch.equal(y.detach(), x.detach())
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(3))


@pytest.mark.parametrize("cell,sample_perc", [
    ("gcn_reddit.train_learned", 0.2), ("gcn_reddit.train_learned", 0.6),
    ("gat_gsage_reddit.train_learned", 0.2), ("gcn_reddit.serve_predict", 0.2),
    ("gcn_reddit.train_random", 0.2), ("gcn_reddit.train_random", 0.6)])
def test_the_reference_follows_the_program_in_float32(cell, sample_perc):
    """The program run in float32 on the CPU: every batch field equal, the
    winners equal, the losses, gradients, changes and logits equal to
    rounding. At sample_perc 0.6 q exceeds a partition's valid edges, so a
    small step (the backbone on the whole partition) is among the checked
    steps."""
    torch.manual_seed(0)
    _, _, numbers = small_run(cell, 2 ** 31 + 17, flags=dict(
        dtype="float32", sample_perc=sample_perc))
    assert numbers.pop("batch_mismatch") == 0
    assert numbers.pop("winner_miss", 0.0) == 0
    assert numbers.pop("gate_gap", 0.0) == 0
    for k, v in numbers.items():
        assert v < 1e-4, (k, v)


def test_the_partition_check_reads_every_batch():
    """What the rebuild cannot see: a batch whose valid edges or mask
    sizes are not its part's, an empty part, a node outside every
    part."""
    from benchmark import compare
    run, _, _ = small_run("gcn_reddit.serve_predict", 2 ** 31 + 19)
    assert compare.partition_faults(run) == []
    run.valid_e[1] -= 1
    run.split_counts[2][0] += 1
    assert compare.partition_faults(run) == ["part.1.edges",
                                             "part.2.train"]
    run.valid_e[1] += 1
    run.split_counts[2][0] -= 1
    part = run.part.copy()
    run.part = np.where(part == 0, 1, part)
    assert "part.empty" in compare.partition_faults(run)
    run.part = part.copy()
    run.part[5] = -1
    assert "part.node_outside" in compare.partition_faults(run)
