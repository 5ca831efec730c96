"""Streaming generation: the partial text after every decode window
(``MellowWrapper.generate_stream``; ``mellow_tpu_torch/server.py`` serves it
as Server-Sent Events)."""

import sys

from mellow_tpu_torch.examples.common import main


def task(wrapper, a1, a2):
    final = None
    for texts in wrapper.generate_stream([[a1, a2, "caption the first audio"]], max_len=64):
        final = texts[0]
        print(f"\r{final!r}", end="", file=sys.stderr, flush=True)
    print(file=sys.stderr)
    print(f"final: {final!r}")
    return final


if __name__ == "__main__":
    main(task, __doc__)
