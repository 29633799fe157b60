"""A stand-in for the serving worker that ``cli.api``'s supervisor starts
(``python -m torch_api_stub_worker`` with the worker's argv): it binds
``--host``/``-p``, answers GET /health, and POST with its own pid (POST
/slow after 1.5 s), one response per connection as a supervised worker
closes them, and reports its port through ``--_port_file`` by tmp +
rename. When the file named by ``STUB_WORKER_SLOW_START`` exists it waits
60 s before it binds (a replacement still starting)."""
import argparse
import os
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _reply(self, body: bytes) -> None:
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        self._reply(b'{"status": "ok"}')

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        if self.path == "/slow":
            time.sleep(1.5)
        self._reply(str(os.getpid()).encode())

    def log_message(self, *args):
        pass


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=0)
    p.add_argument("--_port_file", required=True)
    args, _ = p.parse_known_args()
    slow = os.environ.get("STUB_WORKER_SLOW_START")
    if slow and os.path.exists(slow):
        time.sleep(60)
    srv = ThreadingHTTPServer((args.host, args.port), Handler)
    tmp = args._port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(srv.server_address[1]))
    os.replace(tmp, args._port_file)
    srv.serve_forever()


if __name__ == "__main__":
    main()
