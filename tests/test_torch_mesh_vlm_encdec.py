"""The VLM and enc-dec families trained on a mesh (``Trainer(...,
mesh=, recipe=)``) against the JAX package's single-device functions,
on the CPU, through the machinery of ``tests/test_torch_mesh_families.py``
(a world of 2 gloo ranks, a (1, 2) mesh, each rank on its share of this
worker's threads; the JAX init of each smoke config, fp32; the same
numpy batches).

* The init step: InternVL2 with 40 patches + 24 tokens (S/P = 32, so
  rank 0 holds patches only and rank 1 the last 8 patches and the
  tokens), and 8 + 248 on the cluster-sparse backend (S = 256 under
  Ulysses); SeamlessM4T with 32 frames + 64 tokens, and 256 + 256 on
  the cluster-sparse backend (the non-causal sparse encoder under
  Ulysses). The loss equals ``jax.value_and_grad`` of the reference's
  loss within 1e-5 relative, every gradient (summed over the ranks)
  within 1e-4 of the parameter's largest JAX entry.
* Four Trainer steps of InternVL2 and SeamlessM4T (the dense cases)
  equal the JAX Trainer's on the same batches within 1e-4 (the
  reference's bound). The train CLI cannot take these families (its
  token stream carries no patches or frames, nor does the reference's),
  so the Trainer is driven directly, with a task whose batches carry
  them.
"""

import pytest

from test_torch_mesh_families import check_init, check_steps, collect

RUNS = {2: {"init": ("vlm", "vlm_sparse", "encdec", "encdec_sparse"),
            "cli": (), "train": ("vlm", "encdec")}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return collect(tmp_path_factory, RUNS)


@pytest.mark.parametrize("name", RUNS[2]["init"])
def test_init_loss_and_grads_on_mesh_match_jax(runs, name):
    check_init(runs, 2, name)


@pytest.mark.parametrize("name", RUNS[2]["train"])
def test_trainer_mesh_losses_match_jax_trainer(runs, name):
    check_steps(runs, 2, name, "train")
