"""ParamAttr: a parameter's name, initializer, learning-rate scale,
regularizer and trainable flag (the port of
``paddle_tpu/framework/param_attr.py``)."""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None or attr is True:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        # bare initializer
        return ParamAttr(initializer=attr)
