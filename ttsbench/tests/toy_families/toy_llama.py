"""A family for the tests alone: the Llama block under another
`model_type`, counting the calls of each of its functions. It is found
only where a test puts this directory on `ttsbench.families.__path__`."""

from collections import Counter

from ttsbench.families import llama

MODEL_TYPES = ("toy-llama",)
CALLS: Counter = Counter()


def _counted(name):
    fn = getattr(llama, name)

    def call(*args, **kwargs):
        CALLS[name] += 1
        return fn(*args, **kwargs)

    return call


port_config = _counted("port_config")
make_weights = _counted("make_weights")
logits = _counted("logits")
control_params = _counted("control_params")
decode_launch = _counted("decode_launch")
