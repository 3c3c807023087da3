"""Kubernetes job generator for multi-host training on GPU nodes (port of
paddle_tpu/parallel/kube.py).

- ONE workload kind: an Indexed Job (`completionMode: Indexed`) with
  `parallelism == completions == num_ranks`, one pod a rank (a port
  process is one rank, on its own card). There is no pserver tier:
  parameters live sharded on the cards and gradients ride NCCL.
- A headless Service gives pod 0 a stable DNS name; every pod derives
  the rendezvous address from it and its own rank from the Job's
  completion index — the PTPU_* contract that
  parallel.distributed.init_distributed reads, so a training script
  runs unchanged under `parallel.launch` (one host) and on a cluster.
  Every pod sees its card as cuda:0; PTPU_DEVICES says so and
  PTPU_BACKEND asks for NCCL (the pods are distinct cards).
- GPUs are requested through the device plugin's resource name
  (default `nvidia.com/gpu`), plus the `subdomain` needed for pod-to-pod
  DNS; `node_selector` adds any node labels (a GPU product, a pool).

No kubectl or cluster dependency: the generator emits plain manifests
(`dict`s; `to_yaml` serializes), so tests validate structure without a
cluster.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["gen_job", "gen_service", "gen_manifests", "to_yaml", "main"]

_DNS1123_MAX = 63


def _check_name(name: str) -> str:
    ok = (0 < len(name) <= _DNS1123_MAX
          and name[0].isalnum() and name[-1].isalnum()
          and all(c.isalnum() or c == "-" for c in name)
          and name == name.lower())
    if not ok:
        raise ValueError(
            f"job name {name!r} is not a DNS-1123 label "
            "(lowercase alphanumerics and '-', max 63 chars)")
    return name


def gen_service(name: str, coordinator_port: int = 8476) -> Dict[str, Any]:
    """Headless Service so pods resolve each other (and rank 0) by DNS."""
    _check_name(name)
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "labels": {"ptpu-job": name}},
        "spec": {
            "clusterIP": "None",                 # headless: DNS only
            "selector": {"ptpu-job": name},
            "ports": [{"name": "coordinator", "port": coordinator_port}],
        },
    }


def gen_job(name: str,
            image: str,
            command: Sequence[str],
            num_ranks: int = 1,
            gpu_resource: str = "nvidia.com/gpu",
            gpus_per_rank: int = 1,
            node_selector: Optional[Dict[str, str]] = None,
            cpu: Optional[str] = None,
            memory: Optional[str] = None,
            env: Optional[Dict[str, str]] = None,
            coordinator_port: int = 8476,
            backoff_limit: int = 0) -> Dict[str, Any]:
    """Indexed Job: one pod a rank, rank and rendezvous wired by PTPU_*.

    Pod i gets PTPU_PROCESS_ID=i (from the completion index),
    PTPU_NUM_PROCESSES=num_ranks, PTPU_COORDINATOR pointing at pod 0's
    stable DNS name `{name}-0.{name}:{coordinator_port}`, and
    PTPU_DEVICES / PTPU_BACKEND for one card a pod over NCCL.
    """
    _check_name(name)
    if num_ranks < 1:
        raise ValueError("num_ranks must be >= 1")
    # pod hostnames are "{name}-{index}" and must also be DNS-1123 labels
    longest = f"{name}-{num_ranks - 1}"
    if len(longest) > _DNS1123_MAX:
        raise ValueError(
            f"job name {name!r} too long: pod hostname {longest!r} "
            f"exceeds {_DNS1123_MAX} chars")
    if not command:
        raise ValueError("command must be non-empty")

    env_list: List[Dict[str, Any]] = [
        {"name": "PTPU_NUM_PROCESSES", "value": str(num_ranks)},
        # Downward API: the Job controller stamps the index annotation.
        {"name": "PTPU_PROCESS_ID",
         "valueFrom": {"fieldRef": {
             "fieldPath":
                 "metadata.annotations['batch.kubernetes.io/job-completion"
                 "-index']"}}},
        {"name": "PTPU_COORDINATOR",
         "value": f"{name}-0.{name}:{coordinator_port}"},
        {"name": "PTPU_DEVICES", "value": ",".join(["cuda:0"] * num_ranks)},
        {"name": "PTPU_BACKEND", "value": "nccl"},
    ]
    for k, v in sorted((env or {}).items()):
        env_list.append({"name": k, "value": str(v)})

    resources: Dict[str, Dict[str, Any]] = {"limits": {}, "requests": {}}
    if gpus_per_rank:
        resources["limits"][gpu_resource] = gpus_per_rank
        resources["requests"][gpu_resource] = gpus_per_rank
    if cpu:
        resources["requests"]["cpu"] = cpu
    if memory:
        resources["requests"]["memory"] = memory

    pod_spec: Dict[str, Any] = {
        "subdomain": name,                       # pods join the Service DNS
        "restartPolicy": "Never",
        "containers": [{
            "name": "trainer",
            "image": image,
            "command": list(command),
            "env": env_list,
            "ports": [{"containerPort": coordinator_port}],
            "resources": resources,
        }],
    }
    if node_selector:
        pod_spec["nodeSelector"] = dict(node_selector)

    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {"name": name, "labels": {"ptpu-job": name}},
        "spec": {
            "completionMode": "Indexed",
            "completions": num_ranks,
            "parallelism": num_ranks,
            "backoffLimit": backoff_limit,
            "template": {
                "metadata": {"labels": {"ptpu-job": name}},
                "spec": pod_spec,
            },
        },
    }


def gen_manifests(name: str, image: str, command: Sequence[str],
                  num_ranks: int = 1, **kw) -> List[Dict[str, Any]]:
    """Service + Job, ready to serialize into one multi-doc YAML."""
    return [gen_service(name, kw.get("coordinator_port", 8476)),
            gen_job(name, image, command, num_ranks=num_ranks, **kw)]


def to_yaml(manifests: Sequence[Dict[str, Any]]) -> str:
    """Serialize manifests to a multi-document YAML string: PyYAML when
    available, else JSON documents, which are valid YAML (kubectl
    applies either)."""
    try:
        import yaml
        return "---\n".join(
            yaml.safe_dump(m, default_flow_style=False, sort_keys=False)
            for m in manifests)
    except ImportError:
        return "---\n".join(json.dumps(m, indent=2) + "\n"
                            for m in manifests)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.parallel.kube",
        description="Generate k8s manifests for a multi-rank training job "
                    "on GPU nodes.")
    p.add_argument("--name", default="ptpu-job")
    p.add_argument("--image", required=True)
    p.add_argument("--ranks", type=int, default=1)
    p.add_argument("--gpus-per-rank", type=int, default=1)
    p.add_argument("--gpu-resource", default="nvidia.com/gpu")
    p.add_argument("--node-selector", action="append", default=[],
                   metavar="K=V", help="node label (repeatable)")
    p.add_argument("--cpu", default=None)
    p.add_argument("--memory", default=None)
    p.add_argument("--env", action="append", default=[],
                   metavar="K=V", help="extra container env (repeatable)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command, e.g. python train.py --lr 0.1")
    args = p.parse_args(argv)
    cmd = list(args.command)
    if cmd and cmd[0] == "--":   # strip only the argparse separator
        cmd = cmd[1:]
    if not cmd:
        p.error("missing training command")

    def pairs(items, flag):
        out = {}
        for kv in items:
            if "=" not in kv:
                p.error(f"{flag} expects K=V, got {kv!r}")
            k, _, v = kv.partition("=")
            out[k] = v
        return out
    manifests = gen_manifests(
        args.name, args.image, cmd, num_ranks=args.ranks,
        gpu_resource=args.gpu_resource, gpus_per_rank=args.gpus_per_rank,
        node_selector=pairs(args.node_selector, "--node-selector"),
        cpu=args.cpu, memory=args.memory, env=pairs(args.env, "--env"))
    print(to_yaml(manifests))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
