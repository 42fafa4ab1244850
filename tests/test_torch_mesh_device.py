"""`parallel/mesh.data_parallel_mesh` without `devices` is the current
card's mesh: where no card is visible it raises, with the entry points'
message, before it joins or creates a process group. A mesh on the CPU
takes an explicit `devices=["cpu"] * world` (the tests' and the CPU
training CLI's)."""

import pytest
import torch
import torch.distributed as dist

from suo_slam_tpu_torch.parallel import mesh as pm


@pytest.mark.parametrize("kw", [dict(init_method="file"), dict(init_method="file", rank=0),
                                dict(init_method="tcp", rank=0), dict(init_method="env://"),
                                dict()], ids=["file", "file-rank", "tcp-rank", "env", "none"])
def test_mesh_without_devices_raises_without_a_card(tmp_path, monkeypatch, kw):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card contract is not testable")
    init_file = tmp_path / "group"
    kw = dict(kw)
    if kw.get("init_method") == "file":
        kw["init_method"] = f"file://{init_file}"
    elif kw.get("init_method") == "tcp":
        kw["init_method"] = "tcp://localhost:1"
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(RuntimeError, match=r"device='cuda' requested but .*pass device='cpu'"):
        pm.data_parallel_mesh(**kw)
    assert not dist.is_initialized()
    assert not init_file.exists()
