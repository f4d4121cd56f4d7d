from .curriculum_scheduler import CurriculumScheduler  # noqa: F401
