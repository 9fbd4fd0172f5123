"""Does a SIGKILLed server's port leave a connection open that nothing answers?

A child process listens on a loopback port and never accepts; with
``--cuda-gb N`` it first takes N GiB on the card, so that its teardown
after a SIGKILL takes a while. The parent connects and sends a request,
SIGKILLs the child, then keeps connecting every 5 ms until a connect is
refused. Each connection that got through (the one made before the kill
and any made while the child tore down) then waits up to ``--wait-s`` for
an answer: a reset or an end of stream is what a closed listener gives,
a timeout means the connection was left open with nobody behind it. One
JSON line on stdout::

    python3 scripts/port_teardown_probe_torch.py [--cuda-gb 20] [--wait-s 20]
"""
import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

CHILD = """
import socket, sys, time
gb = float(sys.argv[1])
if gb > 0:
    import torch
    keep = torch.empty(int(gb * (1 << 30)), dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()
s = socket.socket()
s.bind(("127.0.0.1", 0))
s.listen(128)
print(s.getsockname()[1], flush=True)
time.sleep(600)
"""
REQUEST = b"POST /prefill HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n\r\n{}"


def answer(sock: socket.socket, wait_s: float) -> str:
    sock.settimeout(wait_s)
    t = time.monotonic()
    try:
        data = sock.recv(64)
        what = "end of stream" if not data else f"data {data[:16]!r}"
    except socket.timeout:
        what = "timeout"
    except OSError as e:
        what = type(e).__name__
    return f"{what} after {time.monotonic() - t:.3f} s"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cuda-gb", type=float, default=0.0)
    ap.add_argument("--wait-s", type=float, default=20.0)
    args = ap.parse_args()
    child = subprocess.Popen([sys.executable, "-c", CHILD, str(args.cuda_gb)],
                             stdout=subprocess.PIPE)
    port = int(child.stdout.readline())
    before = socket.create_connection(("127.0.0.1", port), timeout=5)
    before.sendall(REQUEST)
    t_kill = time.monotonic()
    os.kill(child.pid, signal.SIGKILL)
    during, refused_after = [], None
    while time.monotonic() - t_kill < 30:
        try:
            c = socket.create_connection(("127.0.0.1", port), timeout=1)
        except OSError as e:
            refused_after = (time.monotonic() - t_kill, type(e).__name__)
            break
        c.sendall(REQUEST)
        during.append((time.monotonic() - t_kill, c))
        time.sleep(0.005)
    child.wait()
    reaped_after = time.monotonic() - t_kill
    out = {"cuda_gb": args.cuda_gb, "refused_after_s": refused_after,
           "reaped_after_s": reaped_after,
           "before_kill": answer(before, args.wait_s),
           "connected_during_teardown": len(during),
           "first_during": [[round(t, 4), answer(c, args.wait_s)] for t, c in during[:3]],
           "last_during": [[round(t, 4), answer(c, args.wait_s)] for t, c in during[-2:]]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
