"""Serving: concurrent requests through the port's ``BatchingEngine``, which
coalesces same-parameter requests into one batch and resolves each
caller's future."""

from concurrent.futures import ThreadPoolExecutor

from mellow_tpu_torch.examples.common import main
from mellow_tpu_torch.serving import BatchingEngine

PROMPTS = [
    "caption the first audio.",
    "what is the difference between the two audios?",
    "is there music in either clip? answer yes or no.",
    "which audio is louder?",
]


def task(wrapper, a1, a2):
    engine = BatchingEngine(wrapper, max_batch_size=8, max_wait_ms=50.0)
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            futures = list(pool.map(lambda p: engine.submit(a1, a2, p, max_len=24), PROMPTS))
        answers = [f.result(timeout=600) for f in futures]
    finally:
        engine.shutdown()
    for prompt, answer in zip(PROMPTS, answers):
        print(f"Q: {prompt}\nA: {answer}\n")
    return answers


if __name__ == "__main__":
    main(task, __doc__)
