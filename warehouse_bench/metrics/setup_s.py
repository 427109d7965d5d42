"""setup_s: process start to the window's first send (import, the kernel
library from the compile cache, data, load, resource plan, warm-up)."""


def read(obs):
    return obs["setup_s"]
