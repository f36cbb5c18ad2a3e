"""gs-download-data for gstk_torch: dataset download registry (port of
``gstk_tpu/scripts/download_data.py``, a copy).

Equivalent of the reference ``gs-download-data``
(``gs_toolkit/scripts/downloads/download_data.py:202+`` and
``eyeful_tower.py``): the same dataset families and capture catalogs
(URLs/IDs are public data). Actual downloads require network access —
in a zero-egress build the command degrades to printing the fetch
instructions so users can pull the data out-of-band.

Usage:
  python -m gstk_torch.scripts.download_data list   # all families
  python -m gstk_torch.scripts.download_data nerfstudio --capture poster
  python -m gstk_torch.scripts.download_data eyefultower --capture riverview
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
from pathlib import Path


def _gdrive(file_id: str) -> str:
    return f"https://drive.google.com/uc?id={file_id}"


# nerfstudio capture set (reference download_data.py:92-148)
NERFSTUDIO_CAPTURES = {
    "bww_entrance": _gdrive("1ylkRHtfB3n3IRLf2wplpfxzPTq7nES9I"),
    "campanile": _gdrive("13aOfGJRRH05pOOk9ikYGTwqFc2L1xskU"),
    "desolation": _gdrive("14IzOOQm9KBJ3kPbunQbUTHPnXnmZus-f"),
    "library": _gdrive("1Hjbh_-BuaWETQExn2x2qGD74UwrFugHx"),
    "poster": _gdrive("1dmjWGXlJnUxwosN6MVooCDQe970PkD-1"),
    "redwoods2": _gdrive("1rg-4NoXT8p6vkmbWxMOY6PSG4j3rfcJ8"),
    "storefront": _gdrive("16b792AguPZWDA_YC4igKCwXJqW0Tb21o"),
    "vegetation": _gdrive("1wBhLQ2odycrtU39y2akVurXEAt9SsVI3"),
    "Egypt": _gdrive("1YktD85afw7uitC3nPamusk0vcBdAfjlF"),
    "person": _gdrive("1HsGMwkPu-R7oU7ySMdoo6Eppq8pKhHF3"),
    "kitchen": _gdrive("1IRmNyNZSNFidyj93Tt5DtaEU9h6eJdi1"),
    "plane": _gdrive("1tnv2NC2Iwz4XRYNtziUWvLJjObkZNo2D"),
    "dozer": _gdrive("1jQJPz5PhzTH--LOcCxvfzV_SDLEp1de3"),
    "floating-tree": _gdrive("1mVEHcO2ep13WPx92IPDvdQg66vLQwFSy"),
    "aspen": _gdrive("1X1PQcji_QpxGfMxbETKMeK8aOnWCkuSB"),
    "stump": _gdrive("1yZFAAEvtw2hs4MXrrkvhVAzEliLLXPB7"),
    "sculpture": _gdrive("1CUU_k0Et2gysuBn_R5qenDMfYXEhNsd1"),
    "Giannini-Hall": _gdrive("1UkjWXLN4qybq_a-j81FsTKghiXw39O8E"),
}

# phototourism (IMW 2020; reference download_data.py:293-304)
PHOTOTOURISM_CAPTURES = {
    name: (
        "https://www.cs.ubc.ca/research/kmyi_data/imw2020/TrainingData/"
        f"{path}.tar.gz"
    )
    for name, path in {
        "brandenburg-gate": "brandenburg_gate",
        "buckingham-palace": "buckingham_palace",
        "colosseum-exterior": "colosseum_exterior",
        "grand-palace-brussels": "grand_place_brussels",
        "notre-dame-facade": "notre_dame_front_facade",
        "westminster-palace": "palace_of_westminster",
        "pantheon-exterior": "pantheon_exterior",
        "taj-mahal": "taj_mahal",
        "temple-nara": "temple_nara_japan",
        "trevi-fountain": "trevi_fountain",
    }.items()
}

# sdfstudio data mirrors (reference download_data.py:360-369)
SDFSTUDIO_CAPTURES = {
    "sdfstudio-demo-data": "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data/sdfstudio-demo-data.tar",
    "dtu": "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data/DTU.tar",
    "replica": "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data/Replica.tar",
    "scannet": "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data/scannet.tar",
    "tanks-and-temple": "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data/tnt_advanced.tar",
    "tanks-and-temple-highres": "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data/highresTNT.tar",
    "heritage": "https://s3.eu-central-1.amazonaws.com/avg-projects/monosdf/data/Heritage-Recon.tar",
    "neural-rgbd-data": "http://kaldir.vc.in.tum.de/neural_rgbd/neural_rgbd_data.zip",
}

# mill19 / mega-nerf (reference download_data.py:497-501)
MILL19_CAPTURES = {
    "building": "https://storage.cmusatyalab.org/mega-nerf-data/building-pixsfm.tgz",
    "rubble": "https://storage.cmusatyalab.org/mega-nerf-data/rubble-pixsfm.tgz",
}

# EyefulTower S3 scenes (reference eyeful_tower.py:16-29; fetched from the
# public bucket with awscli: aws s3 sync <url> <dir>)
EYEFULTOWER_BUCKET = (
    "s3://fb-baas-f32eacb9-8abb-11eb-b2b8-4857dd089e15/EyefulTower"
)
EYEFULTOWER_CAPTURES = {
    name: f"{EYEFULTOWER_BUCKET}/{name}/"
    for name in [
        "apartment", "kitchen", "office1a", "office1b", "office2",
        "office_view1", "office_view2", "riverview", "seating_area",
        "table", "workshop",
    ]
}

DATASETS = {
    "mipnerf360": {
        "url": "http://storage.googleapis.com/gresearch/refraw360/360_v2.zip",
        "description": "MipNeRF-360 scenes (garden, bicycle, ...)",
    },
    "blender": {
        "url": _gdrive("18JxhpWD-4ZmuFKLzKlAw-w5PpzZxXOcG"),
        "description": "NeRF synthetic Blender scenes",
    },
    "sitcoms3d": {
        "url": _gdrive("1sgKr0ZO7BQC0FYinAnRSxobIWNucAST5"),
        "description": "sitcoms3D dataset (reference download_data.py:53)",
    },
    "dnerf": {
        "url": _gdrive("1WRZohWMRj0nNlYFIEBwkddDoGPvLTzkR"),
        "description": "D-NeRF dynamic scenes",
    },
    "record3d": {
        "url": _gdrive("1WRZohWMRj0nNlYFIEBwkddDoGPvLTzkR"),
        "description": "Record3D bear capture (reference :233)",
    },
    "nerfstudio": {
        "captures": NERFSTUDIO_CAPTURES,
        "description": "nerfstudio capture set (18 scenes; --capture <name>)",
    },
    "phototourism": {
        "captures": PHOTOTOURISM_CAPTURES,
        "description": "Image Matching Workshop phototourism landmarks",
    },
    "sdfstudio": {
        "captures": SDFSTUDIO_CAPTURES,
        "description": "sdfstudio datasets (DTU, Replica, ScanNet, ...)",
    },
    "mill19": {
        "captures": MILL19_CAPTURES,
        "description": "Mill 19 / mega-NeRF aerial scenes",
    },
    "eyefultower": {
        "captures": EYEFULTOWER_CAPTURES,
        "description": (
            "Eyeful Tower VR captures (S3; fetch with "
            "`aws s3 sync --no-sign-request <url> <dir>`)"
        ),
    },
}


def resolve(dataset: str, capture: str | None) -> list[tuple[str, str]]:
    """(name, url) pairs for a dataset/capture selection; 'all' expands."""
    info = DATASETS[dataset]
    if "url" in info:
        return [(dataset, info["url"])]
    caps = info["captures"]
    if capture in (None, "all"):
        return sorted(caps.items())
    if capture not in caps:
        raise SystemExit(
            f"unknown capture '{capture}' for {dataset}; "
            f"choices: {', '.join(sorted(caps))} or 'all'"
        )
    return [(capture, caps[capture])]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("gs-download-data")
    parser.add_argument("dataset", choices=sorted(DATASETS) + ["list"])
    parser.add_argument("--capture", type=str, default=None,
                        help="capture name within the dataset, or 'all'")
    parser.add_argument("--save-dir", type=Path, default=Path("data"))
    args = parser.parse_args(argv)

    if args.dataset == "list":
        for name, info in DATASETS.items():
            n = len(info.get("captures", {})) or 1
            print(f"{name} ({n} captures): {info['description']}")
        return

    targets = resolve(args.dataset, args.capture)
    args.save_dir.mkdir(parents=True, exist_ok=True)
    for name, url in targets:
        if url.startswith("s3://"):
            print(
                f"{name}: fetch with\n  aws s3 sync --no-sign-request "
                f"{url} {args.save_dir / args.dataset / name}"
            )
            continue
        suffix = ".tar.gz" if ".tar" in url else ".zip"
        target = args.save_dir / f"{name}{suffix}"
        if shutil.which("wget") is None and shutil.which("curl") is None:
            print(f"No downloader available. Fetch manually:\n  {url}")
            continue
        tool = ["wget", "-O", str(target)] if shutil.which("wget") else [
            "curl", "-L", "-o", str(target)
        ]
        try:
            subprocess.run(tool + [url], check=True, timeout=3600)
            shutil.unpack_archive(
                str(target), str(args.save_dir / args.dataset / name)
            )
            print(f"Extracted to {args.save_dir / args.dataset / name}")
        except Exception as e:  # zero-egress environments
            print(f"Download failed ({e}). Fetch manually:\n  {url}")


if __name__ == "__main__":
    main()
