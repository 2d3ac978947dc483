"""Message bus (counterpart of ``oryx_tpu/bus``): the broker abstraction,
the in-process broker, the file bus with its block codec, the shared-memory
ring bus, the TCP bus server and client, the Kafka adapter and the fault
injector (the JAX package's on-disk and wire formats).
"""

from oryx_tpu_torch.bus.core import (  # noqa: F401
    Broker,
    KeyMessage,
    TopicConsumer,
    TopicProducer,
    delete_topic,
    get_broker,
    get_offsets,
    maybe_create_topic,
    set_offsets,
    topic_exists,
)
