"""Worker process of tests/test_torch_multihost.py (not collected by
pytest): one of two processes joined by a gloo group on the CPU, each with
4 CPU devices, the stand-in for two hosts. It drives the port's
multi-process tier (dlimgedit_tpu_torch/parallel/multihost.py):

  1. ``global_mesh(tp=2)``: every tp row is one process's devices;
  2. dp x tp ``encode_frames`` of this process's rows
     (``process_local_batch``, ``local_rows``) against a single-device
     encode of the same frames, max |diff| < 3e-4 (JAX's worker's bound);
  3. one dp train step whose gradient all-reduce crosses the processes:
     the loss against a one-process step on the whole batch (relative
     1e-5), and a digest of the parameters after it, which the spawning
     test holds equal across the ranks;
  4. a checkpoint saved by rank 0 and restored by both, bit for bit.

Prints MULTIHOST-OK on success; any failure exits non-zero.
"""

import hashlib
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    coordinator, num_processes, process_id, ckpt_dir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(2)

    from dlimgedit_tpu_torch.models import sam
    from dlimgedit_tpu_torch.parallel.batch import encode_frames
    from dlimgedit_tpu_torch.parallel.multihost import (
        global_mesh,
        initialize,
        local_rows,
        process_local_batch,
        replicate_params,
    )
    from dlimgedit_tpu_torch.train import step as pstep
    from dlimgedit_tpu_torch.train.checkpoint import (
        restore_train_state,
        save_train_state,
    )

    initialize(coordinator, num_processes, process_id)
    cpu = torch.device("cpu")
    mesh = global_mesh(tp=2, devices=[cpu] * 4)
    assert mesh.shape == {"dp": 4, "tp": 2}, mesh.shape
    for row in mesh.processes:  # tp rows stay inside one process
        assert len(set(row.tolist())) == 1, mesh.processes

    cfg = sam.make_config("mobile_sam", 64)
    # Rank 1 starts from other weights: replicate_params makes them rank 0's.
    model = sam.init_sam(torch.Generator().manual_seed(process_id), cfg)
    model = replicate_params(mesh, model)
    ref = sam.init_sam(torch.Generator().manual_seed(0), cfg)
    for a, b in zip(model.state_dict().values(), ref.state_dict().values()):
        assert torch.equal(a, b)

    B = 8
    rng = np.random.default_rng(7)
    all_frames = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    per = B // num_processes
    mine = all_frames[process_id * per:(process_id + 1) * per]
    emb = encode_frames(model, cfg, process_local_batch(mesh, mine, B),
                        mesh=mesh)
    got = local_rows(emb)
    with torch.inference_mode():
        want = sam.encode_image(ref, cfg, torch.from_numpy(mine)).numpy()
    d_inf = float(np.max(np.abs(got - want)))
    assert got.shape == want.shape and d_inf < 3e-4, (got.shape, d_inf)

    L = cfg.mask_input_size
    batch = {
        "images": all_frames,
        "point_coords": rng.uniform(0, 64, (B, 2, 2)).astype(np.float32),
        "point_labels": np.tile(np.array([[1.0, -1.0]], np.float32), (B, 1)),
        "masks": (rng.random((B, L, L)) > 0.5).astype(np.float32),
    }
    step = pstep.make_train_step(cfg)
    _, _, one_loss, _ = step(ref, pstep.init_train_state(ref), batch)
    m, o, placed = pstep.place_train_state(
        model, pstep.init_train_state(model), batch, mesh)
    m, o, loss, _ = step(m, o, placed)
    loss = float(loss)
    assert abs(loss - float(one_loss)) <= 1e-5 * abs(float(one_loss)), (
        loss, float(one_loss))
    digest = hashlib.sha256(b"".join(
        t.numpy().tobytes() for t in m.state_dict().values())).hexdigest()

    save_train_state(ckpt_dir, 1, m, o)
    like = sam.init_sam(torch.Generator().manual_seed(5), cfg)
    rp, ro, rstep = restore_train_state(ckpt_dir, like=like)
    assert rstep == 1
    for a, b in zip(rp.state_dict().values(), m.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(ro["count"], o["count"])

    print(f"MULTIHOST-OK rank={process_id} mesh={mesh.shape} "
          f"encode_maxd={d_inf:.2e} loss={loss!r} params={digest}",
          flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
