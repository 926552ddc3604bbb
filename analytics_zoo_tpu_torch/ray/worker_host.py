"""``python -m analytics_zoo_tpu_torch.ray.worker_host --connect HOST:PORT
--authkey KEY [--platform cpu]``

Joins a cross-host RayContext as a worker host (the raylet role; reference:
the non-zero barrier partitions running ``ray start`` in
``raycontext.py:166-186``). Counterpart of
``analytics_zoo_tpu/ray/worker_host.py``; its workers run on the card
unless ``--platform cpu`` is given.
"""

import argparse

from .cluster import worker_host_main


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--connect", required=True, help="head HOST:PORT")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--platform", default=None,
                   help="the workers' device: the card by default, 'cpu', "
                        "or 'cuda:N'")
    p.add_argument("--authkey", required=True,
                   help="the head's RayContext.cluster_authkey")
    args = p.parse_args()
    host, port = args.connect.rsplit(":", 1)
    worker_host_main((host, int(port)), num_workers=args.workers,
                     authkey=args.authkey.encode(), platform=args.platform)


if __name__ == "__main__":
    main()
