"""Yes/no audio question answering: a 1-2 token decode."""

from mellow_tpu_torch.examples.common import main, run


def task(wrapper, a1, a2):
    return run(wrapper, [[a1, a1, "is there a siren in the audio? answer yes or no."],
                         [a2, a2, "is music playing? answer yes or no."]], max_len=5)


if __name__ == "__main__":
    main(task, __doc__)
