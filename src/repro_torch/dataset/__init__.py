from repro_torch.aformat.aggregate import AggSpec
from repro_torch.dataset.admission import (AdmissionController, AdmissionTimeout,
                                     LANES)
from repro_torch.dataset.dataset import Dataset, Scanner, dataset
from repro_torch.dataset.format import (AdaptiveFormat, FileFormat, ParquetFormat,
                                  PushdownParquetFormat, TaskRecord,
                                  resolve_format)
from repro_torch.dataset.fragment import Fragment
from repro_torch.dataset.plan import (Aggregate, Count, Filter, FragmentTask,
                                Join, JoinStrategy, Limit, PhysicalPlan,
                                PlanNode, Project, Query, Scan, ScanMetrics)
from repro_torch.dataset.qos import (Shed, TaskContext, TenantRegistry,
                               TenantSpec, as_task_context)
from repro_torch.dataset.scheduler import (ResultCache, ScanScheduler,
                                     modeled_latency)
from repro_torch.dataset.snapshot import (CommitConflict, CompactionReport,
                                    Manifest, MutableDataset)

__all__ = ["AdmissionController", "AdmissionTimeout", "LANES", "AggSpec",
           "Dataset", "ScanMetrics",
           "Scanner", "dataset", "FileFormat", "ParquetFormat",
           "PushdownParquetFormat", "AdaptiveFormat", "TaskRecord",
           "Fragment", "ResultCache", "ScanScheduler", "modeled_latency",
           "Query", "PlanNode", "Scan", "Filter", "Project", "Aggregate",
           "Limit", "Count", "Join", "JoinStrategy", "FragmentTask",
           "PhysicalPlan",
           "resolve_format", "MutableDataset", "Manifest",
           "CommitConflict", "CompactionReport",
           "Shed", "TaskContext", "TenantRegistry", "TenantSpec",
           "as_task_context"]
