"""Two-audio difference explanation: a long decode."""

from mellow_tpu_torch.examples.common import main, run


def task(wrapper, a1, a2):
    return run(wrapper, [[a1, a2, "explain the difference between the two audios."],
                         [a2, a1, "what changed from the first to the second clip?"]], max_len=300)


if __name__ == "__main__":
    main(task, __doc__)
