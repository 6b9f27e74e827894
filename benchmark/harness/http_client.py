"""The open-loop HTTP client, run as a child process so that it shares no
interpreter lock with the server it loads.

It reads one JSON job, a line, from standard input: the server's port,
the queries, each request's query and threshold and its due offset in
seconds, the same for the warm-up, and which replies to keep.  It sends
the warm-up, waits for its replies, writes the line ``warm`` and waits
for the line ``go``; then it opens the window and sends each request
when it is due, whatever the server has answered: one connection a
request, HTTP/1.0, as ``urllib`` or ``curl`` would.  Each request is
timed from when it was due to the last byte of its reply.  It writes one
JSON line to standard output: the window's start on the system's
monotonic clock, and per request the latency, how late it was sent and
whether the reply was a 200; and the kept replies' bodies.  It imports
only the standard library.
"""

from __future__ import annotations

import asyncio
import json
import resource
import sys

TIMEOUT_S = 60.0  # past the window: a reply later than this never came


class Request(asyncio.Protocol):
    def __init__(self, payload: bytes, done):
        self.payload, self.done, self.chunks = payload, done, []

    def connection_made(self, transport):
        transport.write(self.payload)

    def data_received(self, data):
        self.chunks.append(data)

    def connection_lost(self, exc):
        if not self.done.done():
            self.done.set_result(b"".join(self.chunks))


async def fire(loop, port: int, path: str, due: float, out: dict, i: int):
    out["late"][i] = loop.time() - due
    done = loop.create_future()
    payload = ("GET %s HTTP/1.0\r\nHost: 127.0.0.1\r\n\r\n" % path).encode("ascii")
    try:
        await loop.create_connection(lambda: Request(payload, done), "127.0.0.1", port)
        reply = await done
    except OSError:
        return
    out["latency"][i] = loop.time() - due
    head, _, body = reply.partition(b"\r\n\r\n")
    out["ok"][i] = head.startswith(b"HTTP/1.0 200") or head.startswith(b"HTTP/1.1 200")
    if i in out["keep"]:
        out["bodies"][str(i)] = body.decode("utf-8", "replace")


async def send_all(loop, port, queries, requests, offsets, start, out):
    tasks = []
    for i, ((q, threshold), off) in enumerate(zip(requests, offsets)):
        path = "/search?seq=%s&threshold=%r" % (queries[q], threshold)
        due = start + off
        delay = due - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(loop.create_task(fire(loop, port, path, due, out, i)))
    end = start + (offsets[-1] if offsets else 0.0) + TIMEOUT_S
    if tasks:
        await asyncio.wait(tasks, timeout=max(0.0, end - loop.time()))
    for t in tasks:
        if not t.done():
            t.cancel()


def blank(n: int, keep=()) -> dict:
    return {"latency": [None] * n, "late": [None] * n, "ok": [False] * n,
            "keep": set(keep), "bodies": {}}


async def main(job: dict) -> dict:
    loop = asyncio.get_running_loop()
    port = job["port"]
    warm = job["warmup_offsets"]
    warm_out = blank(len(warm))
    queries = job["queries"]
    await send_all(loop, port, queries, job["warmup"], warm, loop.time() + 0.01, warm_out)
    print("warm", flush=True)
    await loop.run_in_executor(None, sys.stdin.readline)
    start = loop.time() + 0.01
    out = blank(len(job["offsets"]), job["keep"])
    await send_all(loop, port, queries, job["requests"], job["offsets"], start, out)
    out.pop("keep")
    out["start"] = start
    out["warmup_failed"] = sum(1 for ok in warm_out["ok"] if not ok)
    return out


if __name__ == "__main__":
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    result = asyncio.run(main(json.loads(sys.stdin.readline())))
    print(json.dumps(result), flush=True)
