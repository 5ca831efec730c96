"""Audio entailment on the v0_s checkpoint: premise, hypothesis, label."""

from mellow_tpu_torch.examples.common import main, run


def task(wrapper, a1, a2):
    return run(wrapper, [[a1, a2, "premise: the first audio contains street noise. hypothesis: the recording "
                                  "was made outdoors. does the audio entail the hypothesis? answer "
                                  "entailment, neutral, or contradiction."]], max_len=20)


if __name__ == "__main__":
    main(task, __doc__, model="v0_s")
