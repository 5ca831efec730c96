"""Open-ended audio question answering."""

from mellow_tpu_torch.examples.common import main, run


def task(wrapper, a1, a2):
    return run(wrapper, [[a1, a1, "what is the main sound source in the audio?"],
                         [a2, a2, "where might this audio have been recorded?"]], max_len=100)


if __name__ == "__main__":
    main(task, __doc__)
