"""Trace-serving launcher: the simulation-as-a-service front end (PyTorch
port of ``repro/launch/serve.py``).

Serves named trained models from an artifact store to concurrent tenants
over a line-delimited JSON protocol (one request object per line, one
response object per line — trivially scriptable with ``nc`` or a
10-line client)::

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --store /var/tmp/repro-store --models skylake-base,big-l1d \\
      --port 7171 --batch-size 8 --warmup 1200,300 --route fused

The store may hold models either package published.  The server runs on
the card (``--device cuda``, the default; ``--device cpu`` only when
asked) and takes the feature ``--route`` ``fused`` (default), ``staged``
or ``host`` (the reference's ``--feature-backend`` ``fused`` / ``pallas``
/ ``numpy``).

Requests (``op`` selects the verb)::

  {"op": "simulate", "model": "skylake-base", "trace": {...encode_trace},
   "tenant": "ci", "metrics": ["cpi"], "request_id": "r1"}
  {"op": "stats"}
  {"op": "models"}

Responses are ``{"ok": true, ...}`` or ``{"ok": false, "error": CODE,
"message": ..., "retry_after_s": ...}`` with the stable ``ServeError``
code vocabulary — QUEUE_FULL and CIRCUIT_OPEN carry the 429-style
backoff hint.  Responses are written as requests complete (pipelined
clients match them up by ``request_id``).

The front end is hostile-input hardened: a line
over ``--max-line-bytes`` or a connection closed mid-line gets a
structured BAD_REQUEST and a clean close (never a stack trace, never an
unbounded buffer); a tenant that disconnects mid-reply loses only its
own responses; per-connection in-flight requests are capped so one
pipelining client cannot hold unbounded server memory.

``--demo`` needs no store: it registers two freshly initialized models
(``torch.Generator`` seeds 0 and 1), drives mixed-tenant load in-process,
and prints the ``ServerStats`` snapshot — the serve-smoke entrypoint.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
from typing import Optional

from ..engine.scheduler import ROUTES
from ..resilience.faults import fault_point
from ..serve import (
    ModelRegistry,
    ServeError,
    ServeRequest,
    TraceServer,
    decode_trace,
)

__all__ = ["main", "serve_forever"]

# longest request line accepted (also the asyncio reader's buffer limit,
# so a tenant streaming garbage without a newline is bounded too)
DEFAULT_MAX_LINE_BYTES = 1 << 20
# in-flight requests per connection before reads backpressure
_MAX_CONN_TASKS = 64


async def _handle_line(server: TraceServer, line: bytes, writer, wlock) -> None:
    async def reply(obj: dict) -> None:
        try:
            async with wlock:
                fault_point("tcp.reply")
                writer.write(json.dumps(obj).encode() + b"\n")
                await writer.drain()
        except (ConnectionError, OSError):  # tao: fault-boundary tenant disconnected mid-reply; only its own responses are lost
            pass

    try:
        req = json.loads(line)
        op = req.get("op", "simulate")
    except (json.JSONDecodeError, AttributeError) as e:
        await reply({"ok": False, "error": "BAD_REQUEST",
                     "message": f"unparseable request: {e}"})
        return

    if op == "stats":
        await reply({"ok": True, "stats": server.stats().to_dict()})
        return
    if op == "models":
        await reply({"ok": True, "models": list(server.registry.names())})
        return
    if op != "simulate":
        await reply({"ok": False, "error": "BAD_REQUEST",
                     "message": f"unknown op {op!r}"})
        return

    rid = req.get("request_id")
    try:
        trace = decode_trace(req["trace"])
        sreq = ServeRequest(
            model=req["model"],
            trace=trace,
            tenant=req.get("tenant", "default"),
            metrics=tuple(req["metrics"]) if req.get("metrics") else None,
            request_id=rid,
            deadline_s=(
                float(req["deadline_s"]) if req.get("deadline_s") is not None
                else None
            ),
        )
    except ServeError as e:
        await reply({"ok": False, **e.to_dict()})
        return
    except (KeyError, ValueError, TypeError) as e:
        await reply({"ok": False, "error": "BAD_REQUEST", "message": str(e),
                     **({"request_id": rid} if rid else {})})
        return
    try:
        result = await server.submit(sreq)
    except ServeError as e:
        await reply({"ok": False, **e.to_dict()})
        return
    await reply({"ok": True, "result": result.to_dict()})


async def _serve_connection(server: TraceServer, reader, writer) -> None:
    wlock = asyncio.Lock()
    tasks = set()

    async def reply_err(message: str) -> None:
        obj = {"ok": False, "error": "BAD_REQUEST", "message": message}
        try:
            async with wlock:
                writer.write(json.dumps(obj).encode() + b"\n")
                await writer.drain()
        except (ConnectionError, OSError):  # tao: fault-boundary peer is already gone; nothing left to tell it
            pass

    try:
        while True:
            try:
                line = await reader.readuntil(b"\n")
            except asyncio.LimitOverrunError:
                # oversized line: the buffered prefix is garbage we refuse
                # to hold — structured error, then close
                await reply_err(
                    "request line exceeds the server's --max-line-bytes limit"
                )
                break
            except asyncio.IncompleteReadError as e:
                # EOF mid-line: a truncated request gets a structured
                # error; a bare EOF (clean disconnect) gets a clean close
                if e.partial.strip():
                    await reply_err(
                        "truncated request (connection closed mid-line)"
                    )
                break
            except (ConnectionResetError, OSError):
                break
            if not line.strip():
                continue
            while len(tasks) >= _MAX_CONN_TASKS:
                # backpressure one pipelining connection instead of
                # buffering unbounded in-flight requests for it
                done, _ = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED
                )
                tasks.difference_update(done)
            t = asyncio.get_running_loop().create_task(
                _handle_line(server, line, writer, wlock)
            )
            tasks.add(t)
            t.add_done_callback(tasks.discard)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
    finally:
        writer.close()
        with contextlib.suppress(ConnectionError, OSError):
            await writer.wait_closed()


async def serve_forever(
    server: TraceServer, host: str, port: int,
    ready: Optional["asyncio.Future"] = None,
    max_line_bytes: int = DEFAULT_MAX_LINE_BYTES,
) -> None:
    """Run the TCP front end until cancelled (``server`` must be started).
    ``ready``, when given, resolves to the bound ``(host, port)`` — pass
    ``port=0`` for an ephemeral port and read the real one from it.
    ``max_line_bytes`` bounds both a single request line and the
    per-connection read buffer."""
    tcp = await asyncio.start_server(
        lambda r, w: _serve_connection(server, r, w), host, port,
        limit=max_line_bytes,
    )
    addr = tcp.sockets[0].getsockname()
    print(f"serving on {addr[0]}:{addr[1]} "
          f"(models: {', '.join(server.registry.names()) or '<none>'})")
    if ready is not None:
        ready.set_result((addr[0], addr[1]))
    async with tcp:
        await tcp.serve_forever()


async def _demo(args) -> None:
    """Self-contained mixed-tenant demo (no store, no trained weights)."""
    import torch

    from ..api import Session, TrainedModel
    from ..core import FeatureConfig, TaoConfig, init_tao

    cfg = TaoConfig(window=9, d_model=16, n_heads=2, n_layers=1, d_ff=32,
                    d_cat=8, features=FeatureConfig(n_buckets=64, n_queue=4,
                                                    n_mem=8))
    sess = Session(cfg, device=args.device)
    traces = [sess.capture("mcf", 1200), sess.capture("dee", 600),
              sess.capture("lee", 6)]
    registry = ModelRegistry(device=args.device)
    for i, name in enumerate(("base", "tuned")):
        params = init_tao(cfg, torch.Generator().manual_seed(i), device=sess.device)
        registry.register(name, TrainedModel(params=params, cfg=cfg, name=name,
                                             device=sess.device))
    server = TraceServer(registry, batch_size=args.batch_size,
                         max_queue=args.max_queue, route=args.route,
                         device=args.device)
    async with server:
        server.warmup([len(t) for t in traces])
        print(f"warm: {server.num_compiles} request-attributed captures")

        async def tenant(name: str, count: int):
            out = []
            for i in range(count):
                tr = traces[i % len(traces)]
                fut = server.submit(ServeRequest(
                    model=("base", "tuned")[i % 2], trace=tr, tenant=name))
                out.append(await fut)
            return out

        done = await asyncio.gather(
            tenant("alice", 6), tenant("bob", 6), tenant("carol", 4),
            tenant("dave", 4))
        for res in done:
            r = res[0]
            print(f"  {r.tenant}: {len(res)} served, first {r.geometry} "
                  f"cpi={float(r.metrics['cpi']):.3f} "
                  f"({r.total_s * 1e3:.1f} ms)")
    print(json.dumps(server.stats().to_dict(), indent=1))


async def _main_async(args) -> None:
    if args.demo:
        await _demo(args)
        return
    if not args.store:
        raise SystemExit("--store is required (or use --demo)")
    registry = ModelRegistry(args.store, device=args.device)
    names = ([n for n in args.models.split(",") if n] if args.models
             else list(registry.names()))
    for name in names:
        registry.resolve(name)       # fail fast on unknown names
    server = TraceServer(
        registry, batch_size=args.batch_size, max_queue=args.max_queue,
        route=args.route, device=args.device,
    )
    async with server:
        if args.warmup:
            lengths = [int(x) for x in args.warmup.split(",") if x]
            info = server.warmup(lengths, models=names)
            print(f"warmup: {info['geometries']} geometries, "
                  f"{info['aot_compiled']} captured")
        await serve_forever(server, args.host, args.port,
                            max_line_bytes=args.max_line_bytes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="serve trained Tao models to concurrent tenants")
    ap.add_argument("--store", default=None,
                    help="artifact store root holding published models")
    ap.add_argument("--models", default=None,
                    help="comma-separated model names (default: all published)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7171)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--route", default="fused", choices=ROUTES,
                    help="feature route: fused (one fused feature kernel per "
                         "batch), staged (whole-trace device arrays) or host "
                         "(NumPy features through the store)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu only when asked)")
    ap.add_argument("--warmup", default=None,
                    help="comma-separated trace lengths to capture the step for")
    ap.add_argument("--max-line-bytes", type=int,
                    default=DEFAULT_MAX_LINE_BYTES,
                    help="longest accepted request line (and the "
                         "per-connection read-buffer cap)")
    ap.add_argument("--demo", action="store_true",
                    help="self-contained in-process demo (no store needed)")
    args = ap.parse_args(argv)
    try:
        asyncio.run(_main_async(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
