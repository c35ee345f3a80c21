"""The distributed train step on the card: world size 1 through
``Plan().train_step`` over an NCCL process group (one spawned rank)
runs ``bench.train_step``'s code, so it gives the same bits at a small
bf16 shape (both fused blocks engage: head dim 128, H and I multiples of
128).

Needs an NVIDIA card with nvcc and skips without one (decided in the
``cuda`` fixture).  On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_dist_cuda.py``.
"""
import pytest
import torch

import torch_dist_workers as workers
from paddle_tpu_torch import bench as tbench
from paddle_tpu_torch.distributed.launch import spawn
from paddle_tpu_torch.models import llama as tllama

pytestmark = pytest.mark.cuda

SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=2, max_position_embeddings=256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA) and nvcc")
    return torch.device("cuda")


def test_world_size_one_over_nccl_equals_the_bench_step(cuda):
    steps = 3
    (got,) = spawn(workers.ws1_steps, 1, (SMALL, steps), device="cuda",
                   timeout=300)
    assert got["backend"] == "nccl"
    cfg = tllama.LlamaConfig(dtype=torch.bfloat16, **SMALL)
    assert tllama._fused_block_modes(cfg, torch.zeros(1, device=cuda)) \
        == (True, True)
    params = tllama.init_params(cfg, 0, device=cuda)
    for t in tbench.leaves(params):
        t.requires_grad_(True)
    opt = tbench.make_optimizer(params)
    batch = workers.ws1_batch(cfg, cuda)
    losses = [tbench.train_step(cfg, params, opt, batch).item()
              for _ in range(steps)]
    assert got["losses"] == losses
    for k, v in tllama._paths(params).items():
        assert torch.equal(got["params"][k], v.detach().cpu()), k
