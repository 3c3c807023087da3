"""The port's Kubernetes job generator (paddle_tpu_torch/parallel/kube.py):
mirrors of tests/test_kube.py with one pod a rank on `nvidia.com/gpu`
and no TPU topology selectors, under the same PTPU_* contract."""

import json
import os
import subprocess
import sys

import pytest

from paddle_tpu_torch.parallel import kube

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_job_structure():
    job = kube.gen_job("trainjob", "registry/img:1", ["python", "train.py"],
                       num_ranks=4, gpus_per_rank=1,
                       node_selector={"nvidia.com/gpu.product":
                                      "NVIDIA-H100-80GB-HBM3"},
                       env={"FLAGS_vlog": "1"})
    assert job["kind"] == "Job"
    spec = job["spec"]
    assert spec["completionMode"] == "Indexed"
    assert spec["completions"] == 4 and spec["parallelism"] == 4
    pod = spec["template"]["spec"]
    assert pod["subdomain"] == "trainjob"
    c = pod["containers"][0]
    assert c["command"] == ["python", "train.py"]
    assert c["resources"]["limits"]["nvidia.com/gpu"] == 1
    assert "google.com/tpu" not in json.dumps(job)
    assert pod["nodeSelector"] == {"nvidia.com/gpu.product":
                                   "NVIDIA-H100-80GB-HBM3"}
    env = {e["name"]: e for e in c["env"]}
    # the PTPU_* contract init_distributed and make_mesh read
    assert env["PTPU_NUM_PROCESSES"]["value"] == "4"
    assert env["PTPU_COORDINATOR"]["value"] == "trainjob-0.trainjob:8476"
    assert "job-completion-index" in json.dumps(env["PTPU_PROCESS_ID"])
    assert env["PTPU_BACKEND"]["value"] == "nccl"
    assert env["PTPU_DEVICES"]["value"] == ",".join(["cuda:0"] * 4)
    assert env["FLAGS_vlog"]["value"] == "1"


def test_service_headless():
    svc = kube.gen_service("trainjob")
    assert svc["spec"]["clusterIP"] == "None"
    assert svc["spec"]["selector"] == {"ptpu-job": "trainjob"}


def test_name_validation():
    with pytest.raises(ValueError):
        kube.gen_job("Bad_Name", "img", ["cmd"])
    with pytest.raises(ValueError):
        kube.gen_job("x" * 64, "img", ["cmd"])
    with pytest.raises(ValueError):
        kube.gen_job("ok", "img", [])
    # pod hostname "{name}-{index}" must itself fit the DNS label limit
    with pytest.raises(ValueError, match="hostname"):
        kube.gen_job("x" * 62, "img", ["cmd"], num_ranks=2)
    kube.gen_job("x" * 61, "img", ["cmd"], num_ranks=2)  # 61+2 = 63 ok


def test_coordinator_port_consistent():
    svc, job = kube.gen_manifests("j", "img", ["c"], num_ranks=2,
                                  coordinator_port=9999)
    assert svc["spec"]["ports"][0]["port"] == 9999
    env = {e["name"]: e for e in
           job["spec"]["template"]["spec"]["containers"][0]["env"]}
    assert env["PTPU_COORDINATOR"]["value"].endswith(":9999")


def test_yaml_roundtrip():
    manifests = kube.gen_manifests("j", "img", ["python", "t.py"],
                                   num_ranks=2)
    text = kube.to_yaml(manifests)
    yaml = pytest.importorskip("yaml")
    docs = [d for d in yaml.safe_load_all(text) if d]
    assert [d["kind"] for d in docs] == ["Service", "Job"]
    assert docs[1]["spec"]["completions"] == 2


def test_cli():
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.parallel.kube",
         "--image", "img:latest", "--ranks", "2",
         "--node-selector", "pool=h100", "--env", "A=b", "--",
         "python", "train.py"],
        capture_output=True, text=True, check=True, cwd=REPO_ROOT)
    assert "completionMode" in out.stdout
    assert "train.py" in out.stdout and "nvidia.com/gpu" in out.stdout
