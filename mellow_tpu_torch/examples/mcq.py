"""Multiple-choice questions over one clip pair, batched."""

from mellow_tpu_torch.examples.common import main, run

PROMPTS = [
    "what can you infer about the surrounding? (a) construction site (b) rural area (c) shopping mall "
    "(d) city street",
    "what is the dominant sound? (a) speech (b) traffic (c) birdsong (d) rain",
    "what time of day does this suggest? (a) morning (b) noon (c) evening (d) night",
    "how busy is the scene? (a) empty (b) quiet (c) moderate (d) crowded",
]


def task(wrapper, a1, a2):
    return run(wrapper, [[a1, a2, p] for p in PROMPTS], max_len=50)


if __name__ == "__main__":
    main(task, __doc__)
