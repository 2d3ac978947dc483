"""Message bus (counterpart of ``oryx_tpu/bus``): the broker abstraction
and the in-process broker. The file, shm, tcp, kafka and fault buses are
not ported yet; ``get_broker`` raises for their locators.
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
