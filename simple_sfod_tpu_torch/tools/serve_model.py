"""Serve detections from an exported artifact over HTTP (the port of the
JAX package's `tools/serve_model.py`): the program that
`simple_sfod_tpu_torch.tools.export_model` wrote, reloaded with this
package's op library and without its model code (engine/serve.py).

    python -m simple_sfod_tpu_torch.tools.serve_model --artifact model.sfodx [--port 8360] [--device cpu]

    curl http://127.0.0.1:8360/                        # artifact info
    curl -X POST --data-binary @street.png \
        'http://127.0.0.1:8360/predict?min_score=0.5'  # detections JSON

The device is CUDA unless --device says otherwise. The first line printed
is "serving ... on http://HOST:PORT/".
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve detections over HTTP from an exported artifact.")
    p.add_argument("--artifact", required=True)
    p.add_argument("--weights", default=None,
                   help="the state dict (.pth) of an artifact exported with --no-bundle-params")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8360)
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="micro-batch coalescing window: concurrent requests arriving within it share one call")
    p.add_argument("--device", default=None, help="default: cuda (fails without a GPU)")
    args = p.parse_args(argv)

    from ..engine.serve import DetectionService, make_server

    service = DetectionService(args.artifact, args.weights, device=args.device, max_wait_ms=args.max_wait_ms)
    srv = make_server(service, args.host, args.port)
    info = service.info()
    print(
        f"serving {info['config'] or 'detector'} ({info['canvas'][0]}x{info['canvas'][1]} canvas, "
        f"batch {info['batch'] or 'poly'}, {info['platforms']}) on http://{args.host}:{srv.server_address[1]}/",
        flush=True,
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        service.close()


if __name__ == "__main__":
    main()
