"""A CPU rehearsal of chip_smoke.py's ``dev`` phase: the port's CLI runs
``dev`` as a child against its fake cluster with two workers, and the
phase's checks hold with ``--device=cpu`` appended to the run in worker
0, at 101 steps (its check step is 100), with bench.py's 10 000-file tree
in the synced path. Its own file, so that
``--dist loadfile`` puts it beside, not behind, the other rehearsals."""

import json

import pytest
import torch

import chip_smoke as cs


def test_dev_phase_rehearsed_on_the_cpu(monkeypatch):
    """Every CLI call exits 0; both workers hold the local ``train.py``
    before and after the edit; the losses file comes back; worker 0's run
    is a gloo world of one, below the loss bound at step 100, with no
    kernel launched; the dev child exits 0 on SIGINT with no exec stream
    left; purge empties the fake."""
    monkeypatch.setitem(cs.DEV, "steps", 101)
    line = cs.phase_dev(torch.device("cpu"), "cpu")
    args = [c["args"] for c in line["cli"]]
    assert args[0] == ["enter", "--all", "--", "sha256sum", "app/train.py"]
    assert args[1][:4] == ["enter", "--worker", "0", "--"]
    assert args[-3:] == [["status", "sync"], ["logs", "--worker", "0"], ["purge"]]
    assert len(args) == 5 + line["edit_polls"]
    assert all(c["rc"] == 0 for c in line["cli"])
    assert set(line["digests_before"]) == set(line["digests_after"]) == {0, 1}
    assert len(set(line["digests_before"].values())) == 1
    assert len(set(line["digests_after"].values())) == 1
    assert line["digests_after"] != line["digests_before"]
    assert line["workers"] == ["jax-mnist-0", "jax-mnist-1"]
    assert line["worker_health"] == {"jax-mnist-0": "authority", "jax-mnist-1": "mirror"}
    assert line["pod_env"] == {"NODE_RANK": "0"}
    assert line["argv"][1:] == ["train.py", "--steps", "101", "--device=cpu"]
    assert line["downstream_file"] == "losses.json"
    assert line["world"].endswith("backend gloo, world 1")
    assert len(line["losses_every_100"]) == 2 and line["loss_at_check_step"] < 1e-3
    assert line["xent_launches"] == 0
    assert line["dev_rc"] == 0 and line["streams_before_stop"] >= 3
    assert line["left_after_purge"] == {"objects": [], "pods": []}
    # the 10 000-file tree went through the port's libdevsync in the dev
    # child and reached both workers; the script's own scans went native
    scanner = line["scanner"]
    assert scanner["mapped_in_dev_child"] == [scanner["library"]]
    assert "/devspace_tpu_torch/_build/libdevsync-" in scanner["library"]
    assert [w["files"] for w in scanner["tree_on_workers"].values()] == [10_000, 10_000]
    assert scanner["entries"] == 10_100
    assert scanner["library_calls"] == {"native": {"walk": 2, "pack_tar": 1}}
    assert set(scanner["seconds"]["native"]) == {"walk_local_tree", "build_tar",
                                                 "directory_hash"}
    json.dumps(line)


def test_scan_tree_native_equals_python(tmp_path):
    """``chip_smoke.scan_tree`` on the dev phase's tree: the native and
    Python scans agree, and only the native one goes through the
    library."""
    cs.write_sync_tree(str(tmp_path))
    scan = cs.scan_tree(str(tmp_path), python=True)
    assert scan["entries"] == 10_100
    assert scan["library_calls"] == {"native": {"walk": 2, "pack_tar": 1},
                                     "python": {"walk": 0, "pack_tar": 0}}
    assert set(scan["seconds"]) == {"native", "python"}
    (tmp_path / "pkg000" / "m000.py").write_bytes(b"y")
    with pytest.raises(AssertionError, match="size differs from the seed"):
        cs.scan_tree(str(tmp_path))
