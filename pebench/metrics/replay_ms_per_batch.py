"""Device ms of one bare replay of the main shape key's program (CUDA
events over five replays, after the judged outputs)."""


def read(rec):
    return rec.get("replay_ms")
