"""Config base model (equivalent of reference ``runtime/config_utils.py:16``).

Built on pydantic v2 directly (the reference carries a pydantic-v1 shim at
``deepspeed/pydantic_v1.py``; we have no legacy surface to preserve).
Supports the reference's deprecated-field mechanism: a field marked
``deprecated=True`` logs a warning and (optionally) forwards its value to
``new_param``.
"""

from pydantic import BaseModel, ConfigDict, model_validator

from ..utils.logging import logger


class DeeperSpeedConfigModel(BaseModel):
    model_config = ConfigDict(
        extra="allow",
        populate_by_name=True,
        validate_default=True,
        validate_assignment=True,
        arbitrary_types_allowed=True,
        protected_namespaces=(),
    )

    def __init__(self, strict=False, **data):
        if not strict:  # filter out None values injected by json "null"
            data = {k: v for k, v in data.items() if v is not None or k.endswith("__")}
        super().__init__(**data)

    @model_validator(mode="after")
    def _process_deprecated(self):
        for name, field in type(self).model_fields.items():
            extra = field.json_schema_extra or {}
            if not isinstance(extra, dict) or not extra.get("deprecated"):
                continue
            value = getattr(self, name, None)
            if value == field.get_default():
                continue
            new_param = extra.get("new_param")
            msg = f"Config parameter {name} is deprecated"
            if new_param:
                msg += f", use {new_param} instead"
                if name in self.model_fields_set and new_param not in self.model_fields_set:
                    try:
                        setattr(self, new_param, value)
                    except Exception:
                        pass  # incompatible type: subclasses translate explicitly
            logger.warning(msg)
        return self

    def get(self, key, default=None):
        return getattr(self, key, default)

    def dict(self, **kwargs):  # pydantic v1 spelling kept for callers
        return self.model_dump(**kwargs)


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_list_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_dict_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)
