"""HTTP/SSE serving front-end + multi-replica router over the port's
engine (port of paddle_tpu/serve/, under the JAX names).

- `sse` — server-sent-events framing + a stdlib streaming client;
- `aio` — the asyncio connection layer (one acceptor thread, a
  coroutine per connection, TLS, slow-client write deadlines);
- `tokenizer` — the seed-deterministic byte tokenizer of the front door;
- `kvxfer` — host-tier KV block transfer between replicas
  (`GET /kvblocks/<digest>` and `pull_prefix`, JAX's wire format);
- `frontend` — `ServeFrontend`: one HTTP port per replica serving
  `POST /v1/completions` (SSE token streaming, cancel on client
  disconnect, per-request deadlines), SLO-burn admission shedding, the
  observability routes, the watchdog and flight recorder, and a SIGTERM
  drain that exits 75;
- `router` — `Router`: prefix-hash sticky routing, the fleet prefix
  directory, phase routing with KV-transfer hints, retry budget,
  hedging, failover with stream resume, federated `/metrics/fleet` and
  stitched `/trace/<id>`;
- `replica` — CLI entry point (`python -m
  paddle_tpu_torch.serve.replica`) building a model + engine +
  front-end in one process, on the CUDA card unless `--device cpu`.
"""

from paddle_tpu_torch.serve.frontend import ServeFrontend
from paddle_tpu_torch.serve.router import Router
from paddle_tpu_torch.serve.sse import (iter_sse, sse_event,
                                        stream_completion)

__all__ = ["ServeFrontend", "Router", "sse_event", "iter_sse",
           "stream_completion"]
