"""Audio captioning."""

from mellow_tpu_torch.examples.common import main, run


def task(wrapper, a1, a2):
    return run(wrapper, [[a1, a1, "caption the audio."], [a2, a2, "describe the sounds in detail."]], max_len=300)


if __name__ == "__main__":
    main(task, __doc__)
