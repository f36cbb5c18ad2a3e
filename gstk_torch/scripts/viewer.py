"""gs-viewer for gstk_torch: view a trained checkpoint in the browser (port
of ``gstk_tpu/scripts/viewer.py``).

    python -m gstk_torch.scripts.viewer --load-config <run>/config.yml [--port 7007] [--device cpu]

Loads the config and the latest checkpoint and serves the interactive
viewer (viser when installed, the stdlib HTTP viewer otherwise) until
interrupted. ``--device`` picks the torch device (default ``cuda``; without
a card and without ``--device`` it raises). ``--port 0`` binds a free port;
the line ``Viewer running at http://localhost:<port>`` names it.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def main(argv=None) -> None:
    from gstk_torch.configs.serialize import load_config
    from gstk_torch.render.renderer import Renderer
    from gstk_torch.viewer.viser_viewer import make_viewer

    parser = argparse.ArgumentParser("gs-viewer")
    parser.add_argument("--load-config", type=Path, required=True)
    parser.add_argument("--port", type=int, default=7007)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu runs the plain "
                             "twins)")
    args = parser.parse_args(argv)

    config = load_config(args.load_config)
    run_dir = Path(args.load_config).parent
    renderer = Renderer(run_dir / "ckpts", model_config=config.model,
                        device=args.device)
    viewer = make_viewer(
        config.model, renderer.raster_config, port=args.port,
        run_info={"config_path": str(args.load_config),
                  "export_dir": str(run_dir / "exports")},
        device=renderer.device,
    ).start()
    viewer.update_scene(renderer.scene, {"step": renderer.step})
    print("Viewer running; Ctrl-C to exit.", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()


if __name__ == "__main__":
    main()
